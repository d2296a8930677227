"""Command-line driver: solve one BA problem.

Parity with the reference CLI `julia src/solve_ba.jl <file> <QR|LDL>
<AMD|Metis> <None|A|J>` (`/root/reference/src/solve_ba.jl:4-27`) and the
scripted `src/main.jl`, re-keyed to this package's option space: the
QR/LDL + ordering + normalization axes collapse into ``--solver``
(``pcg`` = matrix-free Schur+PCG, ``dense`` = dense Schur Cholesky; point
elimination *is* the ordering, block-Jacobi *is* the equilibration — see
SURVEY.md §2.2).

Usage:
    python -m bundleadjustment_jl_tpu.cli <problem.txt[.bz2]> [options]
    python -m bundleadjustment_jl_tpu.cli synthetic:ncams=49,npnts=7776 [...]

Prints the per-iteration log (iter / f / ||J'r|| / lambda / ||d|| / rho —
`src/lm.jl:120-121`) with --verbose, and a final stats block mirroring
``GenericExecutionStats`` (`lm.jl:409-416`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_synthetic(spec: str) -> dict:
    """synthetic:ncams=49,npnts=7776,obs_per_pnt=4,noise_px=0.5,seed=0"""
    out = {}
    body = spec.split(":", 1)[1] if ":" in spec else ""
    for kv in filter(None, body.split(",")):
        k, v = kv.split("=")
        out[k] = float(v) if "." in v or "e" in v.lower() else int(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bundleadjustment_jl_tpu",
        description="Bundle adjustment of BAL problems on an accelerator")
    p.add_argument("problem",
                   help="BAL .txt/.txt.bz2 path or 'synthetic:k=v,...'")
    p.add_argument("--solver", choices=["pcg", "dense", "cgls", "power"],
                   default="pcg",
                   help="linear-step solver: Schur+PCG (default), dense "
                        "Schur Cholesky, damped CGLS on J, or PBA-style "
                        "power series")
    p.add_argument("--driver", choices=["host", "jit", "chunked", "spmd"],
                   default="jit",
                   help="host-stepped loop (rich logging), one-XLA-program, "
                        "the chunked jit driver (max-time + checkpoint "
                        "support at jit speed), or the multi-device "
                        "shard_map driver (use with --mesh N)")
    p.add_argument("--chunk-iters", type=int, default=25,
                   help="iterations per compiled segment (chunked driver)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="rotating step-<n>.npz checkpoints (host/chunked)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint before solving")
    p.add_argument("--facto-dtype", choices=["bf16", "f16"], default=None,
                   help="low-precision factorization storage inside the "
                        "full-precision LM (the reference's facto_type, "
                        "lm.jl:99; jit/chunked drivers)")
    p.add_argument("--dtype", choices=["f32", "f64", "bf16"], default=None,
                   help="working precision (default: f64 on cpu, f32 on "
                        "an accelerator)")
    p.add_argument("--platform", default=None,
                   help="jax platform to select explicitly (e.g. cpu); by "
                        "default JAX's own choice")
    p.add_argument("--max-iters", type=int, default=200)
    p.add_argument("--max-time", type=float, default=3600.0,
                   help="host driver only")
    p.add_argument("--linesearch", action="store_true",
                   help="delta-halving linesearch (lm.jl:263-295)")
    p.add_argument("--pcg-max-iters", type=int, default=100)
    p.add_argument("--pcg-rtol", type=float, default=None,
                   help="fixed PCG tolerance (default: adaptive forcing)")
    p.add_argument("--lam0", type=float, default=None)
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard observations over the first N devices "
                        "(GSPMD; with --driver spmd: point-aligned "
                        "shard_map layout)")
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed (multi-host SPMD: the "
                        "mesh spans every process's devices; set the "
                        "standard JAX_COORDINATOR_ADDRESS/NUM_PROCESSES/"
                        "PROCESS_ID env vars)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of the stats block")
    p.add_argument("--save", default=None, metavar="PATH",
                   help="write the refined problem as a BAL file")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from bundleadjustment_jl_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    if args.multihost:
        # Multi-host SPMD: all processes run this same CLI; collectives
        # are placed by GSPMD exactly as in the single-host case
        # (SURVEY.md §2.3).
        jax.distributed.initialize()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    backend = jax.default_backend()
    dtype_name = args.dtype or ("f64" if backend == "cpu" else "f32")
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    dtype = {"f32": jnp.float32, "f64": jnp.float64,
             "bf16": jnp.bfloat16}[dtype_name]

    from bundleadjustment_jl_tpu.io.bal import read_bal, write_bal
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal

    t0 = time.perf_counter()
    if args.problem.startswith("synthetic"):
        problem, _ = synthetic_bal(dtype=dtype,
                                   **_parse_synthetic(args.problem))
    else:
        problem = read_bal(args.problem, dtype=dtype)
    load_s = time.perf_counter() - t0
    if args.verbose:
        print(f"# {problem.name}: ncams={problem.ncams} "
              f"npnts={problem.npnts} nobs={problem.nobs} "
              f"nvar={problem.nvar} nequ={problem.nequ} "
              f"[{backend}/{dtype_name}, load {load_s:.2f}s]")

    mesh = None
    if args.mesh and args.driver != "spmd":
        from bundleadjustment_jl_tpu.parallel.mesh import (
            make_mesh, shard_problem)
        problem = shard_problem(problem, make_mesh(args.mesh))

    facto_dtype = ({"bf16": jnp.bfloat16, "f16": jnp.float16}
                   .get(args.facto_dtype) if args.facto_dtype else None)
    t0 = time.perf_counter()
    if args.driver == "host":
        from bundleadjustment_jl_tpu.solver.lm import (
            LMOptions, levenberg_marquardt)
        opts = LMOptions(
            max_iters=args.max_iters, max_time=args.max_time,
            solver=args.solver, linesearch=args.linesearch,
            pcg_max_iters=args.pcg_max_iters, pcg_rtol=args.pcg_rtol,
            lam0=args.lam0, verbose=args.verbose,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume)
        res = levenberg_marquardt(problem, opts)
        status, obj = res.status, res.objective
        iters, dual = res.iterations, res.dual_feas
        cg_matvecs = sum(h.get("cg_iters", 0) for h in res.history)
        cams, points = res.cams, res.points
    else:
        from bundleadjustment_jl_tpu.solver.lm_jit import (
            STATUS_NAMES, levenberg_marquardt_jit,
            levenberg_marquardt_jit_chunked)
        kw = dict(max_iters=args.max_iters, lam0=args.lam0,
                  pcg_rtol=args.pcg_rtol, pcg_max_iters=args.pcg_max_iters,
                  use_dense=(args.solver == "dense"),
                  use_cgls=(args.solver == "cgls"),
                  use_power=(args.solver == "power"),
                  linesearch=args.linesearch, facto_dtype=facto_dtype)
        if args.driver == "chunked":
            res = levenberg_marquardt_jit_chunked(
                problem, chunk_iters=args.chunk_iters,
                max_time=args.max_time,
                checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                **kw)
        elif args.driver == "spmd":
            from bundleadjustment_jl_tpu.parallel.mesh import make_mesh
            from bundleadjustment_jl_tpu.parallel.spmd import (
                shard_problem_spmd)
            from bundleadjustment_jl_tpu.solver.lm_spmd import (
                levenberg_marquardt_spmd, levenberg_marquardt_spmd_chunked)
            ndev = min(args.mesh or len(jax.devices()),
                       len(jax.devices()))
            mesh = make_mesh(ndev)
            sp = shard_problem_spmd(problem, ndev, mesh=mesh)
            for k in ("use_dense", "use_cgls", "use_power"):
                if kw.pop(k):
                    raise SystemExit("--driver spmd supports --solver pcg")
            if args.checkpoint_dir or args.resume:
                res = levenberg_marquardt_spmd_chunked(
                    sp, mesh, chunk_iters=args.chunk_iters,
                    max_time=args.max_time,
                    checkpoint_dir=args.checkpoint_dir,
                    resume=args.resume, **kw)
            else:
                res = levenberg_marquardt_spmd(sp, mesh, **kw)
        else:
            res = levenberg_marquardt_jit(problem, **kw)
        jax.block_until_ready(res.objective)
        status = STATUS_NAMES[int(res.status)]
        obj, iters = float(res.objective), int(res.iterations)
        dual = float(res.dual_feas)
        cg_matvecs = int(jax.numpy.sum(res.hist_cg[:iters]))
        cams, points = res.cams, res.points
        if args.verbose:
            import numpy as np
            ho = np.asarray(res.hist_obj[:iters])
            hg = np.asarray(res.hist_gnorm[:iters])
            hl = np.asarray(res.hist_lam[:iters])
            hc = np.asarray(res.hist_cg[:iters])
            print(f"{'iter':>5} {'obj':>14} {'|J.r|':>11} {'lambda':>9} "
                  f"{'cg':>4}")
            for i in range(iters):
                print(f"{i:5d} {ho[i]:14.6e} {hg[i]:11.4e} {hl[i]:9.2e} "
                      f"{hc[i]:4d}")
    elapsed = time.perf_counter() - t0

    rmse = (2.0 * obj / max(problem.nequ, 1)) ** 0.5
    stats = {
        "problem": problem.name, "status": status, "objective": obj,
        "rmse_px": rmse, "iterations": iters, "cg_matvecs": cg_matvecs,
        "elapsed_s": elapsed,
        "dual_feas": dual, "solver": args.solver, "driver": args.driver,
        "dtype": dtype_name, "backend": backend,
    }
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"status:      {status}")
        print(f"objective:   {obj:.6e}   (rmse {rmse:.4f} px)")
        print(f"dual_feas:   {dual:.4e}")
        print(f"iterations:  {iters}")
        print(f"elapsed:     {elapsed:.2f} s")

    if args.save:
        write_bal(args.save, problem.with_state(cams, points))
        if args.verbose:
            print(f"# wrote {args.save}")
    solved = status in ("first_order", "small_residual", "small_step",
                        "small_obj_change")
    return 0 if solved else 1


if __name__ == "__main__":
    sys.exit(main())
