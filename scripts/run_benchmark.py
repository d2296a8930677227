"""Benchmark campaign driver (the reference's `julia src/benchmark.jl` /
`benchmark_diffprec.jl` role): run the solver matrix over the problem
suite, write Markdown + LaTeX tables, JSONL stats and performance-profile
plots under benchmark_results/.

Solver matrix (the reference's facto x perm x normalize x linesearch grid,
`benchmark.jl:31-33`, re-mapped to this architecture's axes):
{pcg, dense, cgls, power} x {ref, nielsen lambda schedule} x {+-linesearch}.

Compile time is reported separately from run time: each (solver, problem)
is solved twice — the first call pays XLA compilation (`compile_s` =
first - second), the second is the reported `elapsed_s` (the reference has
no compile stage; comparing its wall time against a compile-polluted first
run would flatter it). Both clocks stop at `jax.block_until_ready`.

Tier gating on very large problems (logged, never silent): the full
16-config matrix runs where a solve is minutes at most; the biggest
problems run the core configs only — mirroring the reference, which ran
its large problems with the best LDL configs only
(`benchmark/first/lmldlamd_big.log`). `dense` materializes the reduced
camera system and is guarded to ncams <= 512 (the reference's QR config
similarly dies with `exception` rows beyond ~0.5M residuals).

Usage:
    python scripts/run_benchmark.py [--max-nobs N] [--data-dir Data]
                                    [--out benchmark_results] [--diffprec]
                                    [--full-matrix-max-nobs N]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


def build_solvers(full_matrix: bool, dense_max_ncams: int = 512):
    """name -> fn(problem) -> result-protocol object (compile-separated)."""
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, levenberg_marquardt_jit)

    common = dict(max_iters=100, pcg_max_iters=100, lam0_mode="diag",
                  satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                  oatol=0.0, ortol=1e-4)

    def make(kind, strategy, linesearch):
        kw = dict(common)
        if kind == "dense":
            kw["use_dense"] = True
        elif kind == "cgls":
            kw["use_cgls"] = True
        elif kind == "power":
            kw["use_power"] = True
        kw["lam_strategy"] = strategy
        kw["linesearch"] = linesearch

        def solve(problem):
            if kind == "dense":
                # capability gate on actual residency (ncams*npnts), not
                # camera count alone
                from bundleadjustment_jl_tpu.ops.schur import (
                    check_dense_feasible)
                check_dense_feasible(problem.ncams, problem.npnts)

            def once():
                t0 = time.perf_counter()
                r = jax.block_until_ready(
                    levenberg_marquardt_jit(problem, **kw))
                return r, float(r.objective), time.perf_counter() - t0

            r, obj, t_first = once()         # compile + run
            r, obj, t_second = once()        # run (cached executable)

            class R:
                status = STATUS_NAMES[int(r.status)]
                objective = obj
                iterations = int(r.iterations)
                elapsed_time = t_second
                compile_time = max(t_first - t_second, 0.0)
                dual_feas = float(r.dual_feas)
                neval_residual = r.neval_residual
                neval_jac = r.neval_jac
            return R
        return solve

    solvers = {}
    # core = the pcg family only: one XLA program per problem shape.
    kinds = ("pcg", "dense", "cgls", "power") if full_matrix else ("pcg",)
    strategies = ("ref", "nielsen")
    for kind in kinds:
        for strategy in strategies:
            for ls in (False, True) if full_matrix else (False,):
                name = f"lm_{kind}"
                if strategy == "nielsen":
                    name += "_nl"
                if ls:
                    name += "_ls"
                solvers[name] = make(kind, strategy, ls)
    return solvers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-nobs", type=int, default=1_800_000)
    ap.add_argument("--full-matrix-max-nobs", type=int, default=800_000,
                    help="run all 16 configs up to this size; core configs "
                         "beyond (gating is logged)")
    ap.add_argument("--data-dir", default=None,
                    help="real BAL files (default: synthetic suite)")
    ap.add_argument("--out", default="benchmark_results")
    ap.add_argument("--diffprec", action="store_true",
                    help="also run the mixed-precision study")
    ap.add_argument("--diffprec-max-nobs", type=int, default=600_000)
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume: skip (problem, solver) pairs already in "
                         "stats.jsonl")
    ap.add_argument("--skip-main", action="store_true",
                    help="skip the main campaign (diffprec only)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from bundleadjustment_jl_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    from bundleadjustment_jl_tpu.benchmark.problems import (
        bal_suite, synthetic_suite)
    from bundleadjustment_jl_tpu.benchmark.runner import (
        latex_table, markdown_table, performance_profile, run_campaign,
        save_stats)

    os.makedirs(args.out, exist_ok=True)
    backend = jax.default_backend()
    dtype = jnp.float64 if backend == "cpu" else jnp.float32
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)

    d = jax.devices()[0]
    device_tag = {"platform": d.platform, "device_kind": d.device_kind}

    def suite(dt):
        if args.data_dir:
            return bal_suite(args.data_dir, dtype=dt)
        return synthetic_suite(max_nobs=args.max_nobs, dtype=dt)

    full = build_solvers(full_matrix=True)
    core = build_solvers(full_matrix=False)

    # NB: `problems.pad_to_buckets` exists for suites with shared sizes;
    # the BAL ladder has none, and unpadded shapes let bench.py reuse this
    # campaign's compile cache.
    from bundleadjustment_jl_tpu.benchmark.runner import load_stats
    stats_path = os.path.join(args.out, "stats.jsonl")
    rows = []
    done = set()
    if args.skip_existing and os.path.exists(stats_path):
        for r in load_stats(stats_path):
            rows.append(r)
            done.add((r["problem"], r["solver"]))
    if not args.skip_main:
        for name, problem in suite(dtype):
            if problem.nobs <= args.full_matrix_max_nobs:
                solvers = full
            else:
                solvers = core
                print(f"[bmark] {name}: large problem -> core configs only "
                      f"({sorted(core)}; {sorted(set(full) - set(core))} "
                      f"gated)", flush=True)
            todo = {s: f for s, f in solvers.items()
                    if (name, s) not in done}
            if not todo:
                print(f"[bmark] {name}: all rows present, skipping",
                      flush=True)
                continue
            new = run_campaign(todo, [(name, problem)])
            for r in new:
                r.update(device_tag)
            rows += new
            save_stats(rows, stats_path)  # incremental

    with open(os.path.join(args.out, "tables.md"), "w") as f:
        f.write(markdown_table(rows, columns=(
            "problem", "solver", "status", "objective", "rmse_px",
            "iterations", "elapsed_s", "compile_s", "neval_residual",
            "neval_jac", "dual_feas", "nvar", "nequ",
            "platform", "device_kind")) + "\n")
    with open(os.path.join(args.out, "tables.tex"), "w") as f:
        f.write(latex_table(rows) + "\n")
    for cost in ("elapsed_s", "neval_residual", "neval_jac"):
        performance_profile(
            rows, cost, out_path=os.path.join(args.out, f"profile_{cost}.pdf"))
    print(f"wrote {args.out}/{{stats.jsonl,tables.md,tables.tex,"
          f"profile_*.pdf}}", flush=True)

    if args.diffprec:
        from bundleadjustment_jl_tpu.benchmark.precision import (
            facto_solve, precision_cascade)
        from bundleadjustment_jl_tpu.solver.lm_jit import (
            STATUS_NAMES, levenberg_marquardt_jit)
        dpath = os.path.join(args.out, "diffprec.jsonl")
        drows = []
        ddone = set()
        if args.skip_existing and os.path.exists(dpath):
            drows = load_stats(dpath)
            ddone = {r["problem"] for r in drows}
        opts = dict(lam0_mode="diag", satol=0.0, srtol=0.0, atol=0.0,
                    rtol=1e-5, oatol=0.0, ortol=1e-4)
        for name, problem in suite(jnp.float32):
            if name in ddone:
                print(f"[diffprec] {name}: rows present, skipping",
                      flush=True)
                continue
            if problem.nobs > args.diffprec_max_nobs:
                print(f"[diffprec] {name} skipped (> "
                      f"{args.diffprec_max_nobs} obs)", flush=True)
                continue
            # (a) f32 baseline
            t0 = time.perf_counter()
            r = levenberg_marquardt_jit(problem, max_iters=100, **opts)
            obj = float(r.objective)
            base = {"problem": name, "stage": "float32_baseline",
                    "status": STATUS_NAMES[int(r.status)], "objective": obj,
                    "iterations": int(r.iterations),
                    "neval_residual": r.neval_residual,
                    "neval_jac": r.neval_jac,
                    "elapsed_s": time.perf_counter() - t0,
                    "dual_feas": float(r.dual_feas)}
            drows.append(base)
            # (b) f32 LM + bf16 factorization storage (the F3264 analog)
            drows.append({"problem": name,
                          **facto_solve(problem, "bfloat16", max_iters=100,
                                        **opts)})
            # (b') f32 LM + f16 storage with exact power-of-two range
            # equilibration (the reference's F16 facto + normalize_F16!,
            # `benchmark_diffprec.jl:38-94` / `lma_aux.jl:27-52`)
            drows.append({"problem": name,
                          **facto_solve(problem, "float16", max_iters=100,
                                        **opts)})
            # (c) bf16 -> f32 warm-started cascade (the F1632_64 analog)
            for row in precision_cascade(problem,
                                         stages=("bfloat16", "float32"),
                                         max_iters=100, **opts):
                row.pop("cams", None)
                row.pop("points", None)
                drows.append({"problem": name, "stage": "cascade_"
                              + row["stage"], **{k: v for k, v in row.items()
                                                 if k != "stage"}})
            for r_ in drows[-4:]:
                print(f"[diffprec] {name} {r_['stage']}: {r_['status']} "
                      f"obj={r_['objective']:.6g} it={r_['iterations']} "
                      f"t={r_['elapsed_s']:.2f}s", flush=True)
            save_stats(drows, dpath)


if __name__ == "__main__":
    main()
