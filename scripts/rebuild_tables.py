"""Regenerate benchmark_results tables + Dolan-More profiles from
stats.jsonl (after out-of-band appends to it).

The reference regenerates its LaTeX/Markdown tables and profile PDFs from
saved JLD2 stats the same way (`/root/reference/src/benchmark.jl:60-86`).

Usage: python scripts/rebuild_tables.py [--out benchmark_results]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundleadjustment_jl_tpu.benchmark.runner import (  # noqa: E402
    latex_table, load_stats, markdown_table, performance_profile)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmark_results")
    a = ap.parse_args()
    rows = [r for r in load_stats(os.path.join(a.out, "stats.jsonl"))
            if "error" not in r]
    with open(os.path.join(a.out, "tables.md"), "w") as f:
        f.write(markdown_table(rows) + "\n")
    with open(os.path.join(a.out, "tables.tex"), "w") as f:
        f.write(latex_table(rows) + "\n")
    for cost in ("elapsed_s", "iterations", "neval_residual", "neval_jac"):
        performance_profile(
            rows, cost=cost,
            out_path=os.path.join(a.out, f"profile_{cost}.pdf"))
    print(f"rebuilt tables + 4 profiles from {len(rows)} rows")


if __name__ == "__main__":
    main()
