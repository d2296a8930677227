"""Benchmark campaign runner: solver dict x problem suite -> stats tables.

Parity with the reference's `bmark_solvers` harness
(`/root/reference/src/benchmark.jl:53-86`): run every solver on every
problem, collect per-run stats rows, emit Markdown/LaTeX tables (the
``latex_table``/``markdown_table`` role), persist stats as JSON (the JLD2
role), and draw performance profiles over time / #residual evals /
#Jacobian evals (the `profile_solvers` role, same "solved" status set).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, List, Tuple

SOLVED_STATUSES = ("first_order", "small_residual", "small_step",
                   "small_obj_change")  # `benchmark.jl:69-86`

COLUMNS = ("problem", "solver", "status", "objective", "rmse_px",
           "iterations", "elapsed_s", "compile_s", "neval_residual",
           "neval_jac", "dual_feas", "nvar", "nequ")


def run_campaign(solvers: Dict[str, Callable],
                 problems: Iterable[Tuple[str, object]],
                 logger: Callable[[str], None] = print) -> List[dict]:
    """Run each solver on each problem; returns a list of stats rows.

    ``solvers`` maps name -> fn(problem) returning an object with
    ``status/objective/iterations/elapsed_time/dual_feas`` (LMResult) or the
    jitted equivalent.
    """
    rows: List[dict] = []
    for pname, problem in problems:
        for sname, solve in solvers.items():
            logger(f"[bmark] {sname} on {pname} "
                   f"(nvar={problem.nvar}, nequ={problem.nequ})")
            t0 = time.perf_counter()
            try:
                res = solve(problem)
                elapsed = time.perf_counter() - t0
                status = getattr(res, "status", "unknown")
                if not isinstance(status, str):   # jit result: int code
                    from bundleadjustment_jl_tpu.solver.lm_jit import (
                        STATUS_NAMES)
                    status = STATUS_NAMES[int(status)]
                obj = float(getattr(res, "objective"))
                row = {
                    "problem": pname, "solver": sname, "status": status,
                    "objective": obj,
                    "rmse_px": (2.0 * obj / max(problem.nequ, 1)) ** 0.5,
                    "iterations": int(getattr(res, "iterations")),
                    "elapsed_s": float(getattr(res, "elapsed_time", elapsed)),
                    "compile_s": float(getattr(res, "compile_time", 0.0)),
                    "neval_residual": int(getattr(res, "neval_residual", -1)),
                    "neval_jac": int(getattr(res, "neval_jac", -1)),
                    "dual_feas": float(getattr(res, "dual_feas")),
                    "nvar": problem.nvar, "nequ": problem.nequ,
                }
            except Exception as e:  # the reference records `exception` rows
                # One clean line per failure (the reference's discipline,
                # `benchmark/first/lmqramd.log`): classify capability
                # bounds (MemoryError from an explicit gate) vs runtime
                # errors, and truncate XLA boilerplate.
                msg = repr(e)
                if len(msg) > 300:
                    key = next((ln for ln in msg.splitlines()
                                if "RESOURCE_EXHAUSTED" in ln
                                or "error:" in ln.lower()), "")
                    msg = (key or msg)[:300]
                kind_e = ("capability" if isinstance(e, MemoryError)
                          else "exception")
                row = {"problem": pname, "solver": sname,
                       "status": kind_e, "objective": float("inf"),
                       "rmse_px": float("inf"), "iterations": 0,
                       "elapsed_s": time.perf_counter() - t0,
                       "neval_residual": -1, "neval_jac": -1,
                       "dual_feas": float("inf"),
                       "nvar": problem.nvar, "nequ": problem.nequ,
                       "error": msg}
            rows.append(row)
            logger(f"[bmark]   -> {row['status']} obj={row['objective']:.6g} "
                   f"iters={row['iterations']} t={row['elapsed_s']:.2f}s")
    return rows


def markdown_table(rows: List[dict], columns=COLUMNS) -> str:
    """`markdown_table` role (`benchmark.jl:66-67`)."""
    head = "| " + " | ".join(columns) + " |"
    sep = "|" + "|".join("---" for _ in columns) + "|"
    body = []
    for r in rows:
        cells = []
        for c in columns:
            v = r.get(c, "")
            cells.append(f"{v:.6g}" if isinstance(v, float) else str(v))
        body.append("| " + " | ".join(cells) + " |")
    return "\n".join([head, sep] + body)


def latex_table(rows: List[dict], columns=COLUMNS) -> str:
    """`latex_table` role (`benchmark.jl:62-65`)."""
    lines = [r"\begin{tabular}{" + "l" * len(columns) + "}",
             " & ".join(c.replace("_", r"\_") for c in columns) + r" \\",
             r"\hline"]
    for r in rows:
        cells = []
        for c in columns:
            v = r.get(c, "")
            s = f"{v:.6g}" if isinstance(v, float) else str(v)
            cells.append(s.replace("_", r"\_"))
        lines.append(" & ".join(cells) + r" \\")
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def save_stats(rows: List[dict], path: str) -> None:
    """Persist stats (the JLD2 role, `benchmark.jl:60`) as JSON lines."""
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def load_stats(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def performance_profile(rows: List[dict], cost: str = "elapsed_s",
                        out_path: str | None = None):
    """Dolan-More performance profiles over solvers (the `profile_solvers`
    role, `benchmark.jl:69-86`; same cost axes: time / #r evals / #J evals).

    Returns (taus, {solver: fraction-solved-within-tau}); optionally writes
    a PDF/PNG via matplotlib when ``out_path`` is given.
    """
    import numpy as np

    solvers = sorted({r["solver"] for r in rows})
    problems = sorted({r["problem"] for r in rows})
    costs = np.full((len(problems), len(solvers)), np.inf)
    for r in rows:
        i = problems.index(r["problem"])
        j = solvers.index(r["solver"])
        if r["status"] in SOLVED_STATUSES and np.isfinite(r.get(cost, np.inf)):
            costs[i, j] = max(float(r[cost]), 1e-12)
    if costs.size == 0:
        return None   # nothing to profile (e.g. an empty campaign)
    best = costs.min(axis=1, keepdims=True)
    ratios = np.where(np.isfinite(best), costs / best, np.inf)
    finite = ratios[np.isfinite(ratios)]
    tau_max = float(finite.max()) * 1.05 if finite.size else 2.0
    taus = np.linspace(1.0, max(tau_max, 1.01), 256)
    profile = {
        s: np.array([(ratios[:, j] <= t).mean() for t in taus])
        for j, s in enumerate(solvers)
    }
    if out_path is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4))
        for s in solvers:
            ax.step(taus, profile[s], where="post", label=s)
        ax.set_xlabel(f"within factor tau of best ({cost})")
        ax.set_ylabel("fraction of problems solved")
        ax.set_ylim(0, 1.02)
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
    return taus, profile
