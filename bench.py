"""Benchmark: full LM solves on one GPU at two BAL benchmark sizes.

Cells (synthetic problems of the exact BAL dimensions,
`benchmark/problems.py:BAL_SIZES`; no BAL file is downloaded):

- LadyBug-49 (49 cameras, 7,776 points, ~31k observations), f32;
- Dubrovnik-356 (356 cameras, 226,730 points, 1,360,380 observations)
  in f32, with the per-observation W blocks stored three ways: f32,
  bf16 and f16 (``facto_dtype``, the reference's ``facto_type``).

Every cell reports status, LM iterations, CG matvecs, rmse_px, set-up
seconds (host generation, host-to-device transfer, compilation of the
init and run programs), the solve seconds of each timed repeat,
``memory_analysis()`` of both compiled programs and the device's
``peak_bytes_in_use``. The solve clock runs on a device-resident problem
and stops at ``jax.block_until_ready`` of the result.

Reference baselines (BASELINE.md, Julia LM-LDL F64 on the author's CPU):
LadyBug-49 = 54.3 s / 57 it; Dubrovnik-356 = ~1.2e3 s / 19 it.

Requires a GPU: with no GPU backend it exits with an error instead of
timing the host. Prints one JSON line per cell; the last line is the
Dubrovnik-356 f32 headline.

    python bench.py
"""

import functools
import json
import statistics
import subprocess
import time

import jax
import jax.numpy as jnp

BASE_DUBROVNIK_S = 1200.0   # LM-LDL F64, Dubrovnik-356 (BASELINE.md)
SOLVED = ("first_order", "small_residual", "small_step", "small_obj_change")

# Solver options shared by every cell.
SOLVE_OPTS = dict(max_iters=100, pcg_max_iters=100, lam0_mode="diag",
                  satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0,
                  ortol=1e-4)

FACTO = {"f32": None, "bf16": jnp.bfloat16, "f16": jnp.float16}


@functools.cache
def ladybug(seed):
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    p, _ = synthetic_bal(ncams=49, npnts=7776, obs_per_pnt=4, noise_px=1.0,
                         perturb=2e-2, seed=seed, dtype=jnp.float32,
                         pad_obs_to=512)
    return p


@functools.cache
def dubrovnik(seed):
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    p, _ = synthetic_bal(ncams=356, npnts=226730, obs_per_pnt=6,
                         noise_px=1.0, perturb=2e-2, seed=seed,
                         dtype=jnp.float32, pad_obs_to=512)
    return p


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> None:
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's backend is {backend!r}; this "
                         f"benchmark times the GPU only")


def memory_fields(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes")}


def run_cell(name, make_problem, facto="f32", repeats=3) -> dict:
    """Generate, transfer, compile, then time ``repeats`` solves."""
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, compile_lm, levenberg_marquardt_jit)
    fd = FACTO[facto]
    t0 = time.perf_counter()
    host = make_problem(seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = jax.block_until_ready(jax.device_put(host))
    transfer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    init, run = compile_lm(problem, facto_dtype=fd, **SOLVE_OPTS)
    compile_s = time.perf_counter() - t0
    # first execution loads the compiled programs; not timed as a solve
    t0 = time.perf_counter()
    jax.block_until_ready(
        levenberg_marquardt_jit(problem, facto_dtype=fd, **SOLVE_OPTS))
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = jax.block_until_ready(
            levenberg_marquardt_jit(problem, facto_dtype=fd, **SOLVE_OPTS))
        times.append(time.perf_counter() - t0)
    it = int(res.iterations)
    obj = float(res.objective)
    row = {
        "cell": name, "facto": facto, "device": device_info(),
        "status": STATUS_NAMES[int(res.status)], "iterations": it,
        "cg_matvecs": int(jnp.sum(res.hist_cg[:it])),
        "objective": obj,
        "rmse_px": (2.0 * obj / problem.nequ) ** 0.5,
        "nobs": problem.nobs,
        "setup_s": {"generate": gen_s, "transfer": transfer_s,
                    "compile": compile_s, "first_run": first_s},
        "solve_s": times, "solve_s_median": statistics.median(times),
        "memory_analysis": {"init": memory_fields(init),
                            "run": memory_fields(run)},
        "peak_bytes_in_use": int(
            jax.devices()[0].memory_stats()["peak_bytes_in_use"]),
    }
    return row


def main():
    require_gpu()
    from bundleadjustment_jl_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    print(gpu_name_and_power())
    rows = [run_cell("ladybug49", ladybug, "f32")]
    for facto in ("bf16", "f16", "f32"):
        rows.append(run_cell("dubrovnik356", dubrovnik, facto))
    for row in rows:
        print(json.dumps(row))
    bad = [r for r in rows if r["status"] not in SOLVED]
    if bad:
        raise SystemExit(f"unsolved cells: {[(r['cell'], r['facto'], r['status']) for r in bad]}")
    head = rows[-1]
    print(json.dumps({
        "metric": "dubrovnik356_synth_lm_solve",
        "value": head["solve_s_median"], "unit": "s",
        "vs_baseline": BASE_DUBROVNIK_S / head["solve_s_median"],
        "device": head["device"], "status": head["status"],
        "iterations": head["iterations"],
        "cg_matvecs": head["cg_matvecs"], "rmse_px": head["rmse_px"]}))


if __name__ == "__main__":
    main()
