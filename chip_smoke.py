"""Smoke test of the bundle-adjustment solver on one GPU, in one process.

Runs the system's main path — the one-program LM solve
(`solver/lm_jit.py:levenberg_marquardt_jit`) through its entry points —
at Dubrovnik-356 size (356 cameras, 226,730 points, 1,360,380
observations, data generated from a seed), and checks it against plain
float64 references. Phases, in order; the first failure stops the run
with a non-zero exit:

1. device: JAX's platform must be ``gpu``; prints the card's name and
   power limit (nvidia-smi);
2. compile: the Dubrovnik-356 init and run programs for W stored in
   f32, bf16 and f16, with their ``memory_analysis()``;
3. stages: every XLA stage of one LM iteration at Dubrovnik-356 against
   the numpy float64 reference of `benchmark/parity.py`, per W storage
   precision, each under its stated tolerance; each bound must also
   reject a control (`parity.precision_controls`);
4. solve parity: LadyBug-49 solved in f32 on the GPU and in f64 on the
   CPU (a child process pinned to the CPU platform);
5. entry points: ``cli.main`` on Dubrovnik-356, and the three
   Dubrovnik-356 cells of ``bench.py`` (f32, bf16 W, f16 W); each must
   reach a solved status with rmse_px < 1.0 (the noise is 1 px);
6. chip tests: the tests marked ``chip`` (`pytest -m chip`), in this
   process.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four`` runs only the four-card path instead: synthetic Venice-1778
(~5M observations, f32) solved on one card and on four cards through
both multi-device layouts (GSPMD `parallel/mesh.py`, and `shard_map`
`parallel/spmd.py` + `solver/lm_spmd.py`), which must match it.

    python chip_smoke.py [--four]
"""

import argparse
import contextlib
import io
import json
import sys
import time


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"=== phase: {name}")
    return time.perf_counter()


def done(name, t0, **info):
    log(f"--- {name} ok ({time.perf_counter() - t0:.1f} s) "
        + json.dumps(info))


def device_phase(want_count):
    import jax
    import bench
    t0 = phase("device")
    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    log(json.dumps(info))
    if jax.default_backend() != "gpu" or d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's backend is "
                         f"{jax.default_backend()!r}")
    if info["count"] < want_count:
        raise SystemExit(f"needs {want_count} GPUs, found {info['count']}")
    log(bench.gpu_name_and_power())
    done("device", t0)
    return info


def compile_phase(problem):
    import bench
    from bundleadjustment_jl_tpu.solver.lm_jit import compile_lm
    t0 = phase("compile Dubrovnik-356 init and run programs")
    for facto, fd in bench.FACTO.items():
        t1 = time.perf_counter()
        init, run = compile_lm(problem, facto_dtype=fd, **bench.SOLVE_OPTS)
        log(json.dumps({"facto": facto,
                        "compile_s": time.perf_counter() - t1,
                        "init": bench.memory_fields(init),
                        "run": bench.memory_fields(run)}))
    done("compile", t0)


def stage_phase(problem):
    from bundleadjustment_jl_tpu.benchmark import parity
    t0 = phase("stage parity at Dubrovnik-356 vs numpy float64")
    t1 = time.perf_counter()
    ref = parity.Reference(problem)
    log(f"float64 reference built in {time.perf_counter() - t1:.1f} s")
    worst = {}
    for facto in ("f32", "bf16", "f16"):
        errs = parity.stage_errors(problem, facto, "auto", ref=ref)
        tol = parity.TOLERANCE[facto]
        by_stage = parity.worst_by_stage(errs)
        log(json.dumps({"facto": facto, "tolerance": tol,
                        "errors": errs}))
        bad = {k: e for k, e in by_stage.items() if not e <= tol}
        if bad:
            raise SystemExit(f"stage parity {facto}: over {tol}: {bad}")
        worst[facto] = max(by_stage.values())
    # Each bound must reject its control: a TF32 product for f32, bf16
    # arithmetic for bf16 W, and W stored in bf16 for f16 W.
    ctl = parity.precision_controls(ref)
    ctl["bf16_storage"] = worst["bf16"]
    log(json.dumps({"controls": ctl}))
    for facto, c in (("f32", "tf32"), ("bf16", "bf16_accumulation"),
                     ("f16", "bf16_storage")):
        if not parity.TOLERANCE[facto] < ctl[c]:
            raise SystemExit(f"the {facto} bound {parity.TOLERANCE[facto]}"
                             f" does not reject its control {c}: {ctl[c]}")
    done("stages", t0, worst=worst)


def solve_phase(child):
    import jax.numpy as jnp
    from bundleadjustment_jl_tpu.benchmark import parity
    t0 = phase("LadyBug-49: f32 on the GPU vs f64 on the CPU")
    gpu = parity.solve_summary(parity.LADYBUG49, jnp.float32)
    cpu = child()
    log(json.dumps({"gpu_f32": gpu, "cpu_f64": cpu,
                    "rtol": parity.SOLVE_RTOL}))
    if gpu["platform"] != "gpu" or cpu["platform"] != "cpu":
        raise SystemExit("solve parity ran on the wrong platforms")
    if not parity.solves_agree(gpu, cpu):
        raise SystemExit("LadyBug-49 f32 GPU solve disagrees with f64 CPU")
    rel = abs(gpu["objective"] - cpu["objective"]) / cpu["objective"]
    done("solve parity", t0, objective_rel_diff=rel)


def entry_phase():
    import bench
    from bundleadjustment_jl_tpu import cli
    t0 = phase("entry points at Dubrovnik-356")
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["synthetic:ncams=356,npnts=226730,obs_per_pnt=6,"
                       "noise_px=1.0,perturb=2e-2,pad_obs_to=512",
                       "--dtype", "f32", "--max-iters", "100", "--json"])
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    stats["wall_s"] = time.perf_counter() - t1
    log("cli " + json.dumps(stats))
    if rc != 0 or stats["backend"] != "gpu" or not stats["rmse_px"] < 1.0:
        raise SystemExit(f"cli solve failed: rc={rc}")
    for facto in ("f32", "bf16", "f16"):
        row = bench.run_cell("dubrovnik356", bench.dubrovnik, facto,
                             repeats=1)
        log("bench " + json.dumps(row))
        if row["status"] not in bench.SOLVED or not row["rmse_px"] < 1.0:
            raise SystemExit(f"bench cell {facto}: {row['status']}, "
                             f"rmse {row['rmse_px']}")
    done("entry points", t0)


def chip_test_phase():
    import pytest
    t0 = phase("chip tests (pytest -m chip)")
    rc = pytest.main(["-q", "-m", "chip", "-n", "0", "-p",
                      "no:cacheprovider", "tests/test_chip.py"])
    if rc != 0:
        raise SystemExit(f"chip tests failed: pytest exit {rc}")
    done("chip tests", t0)


VENICE1778 = dict(ncams=1778, npnts=993923, obs_per_pnt=5, noise_px=1.0,
                  perturb=2e-2, seed=0, pad_obs_to=512)
# Four shards reassociate every f32 camera-space sum, and the solve stops
# on a relative objective change of 1e-4 (bench.SOLVE_OPTS), so two
# trajectories may stop up to about that far apart.
FOUR_RTOL = 1e-3


def four_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.parallel.mesh import make_mesh, shard_problem
    from bundleadjustment_jl_tpu.parallel.spmd import shard_problem_spmd
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, compile_lm, levenberg_marquardt_jit)
    from bundleadjustment_jl_tpu.solver.lm_spmd import (
        levenberg_marquardt_spmd)

    t0 = phase("Venice-1778 on one card and on four")
    host, _ = synthetic_bal(dtype=np.float32, **VENICE1778)
    log(f"generated nobs={host.nobs} in {time.perf_counter() - t0:.1f} s")

    def summary(res, t):
        it = int(res.iterations)
        return {"status": STATUS_NAMES[int(res.status)], "iterations": it,
                "cg_matvecs": int(jnp.sum(res.hist_cg[:it])),
                "objective": float(res.objective), "wall_s": t}

    def timed(fn):
        t1 = time.perf_counter()
        res = jax.block_until_ready(fn())
        return summary(res, time.perf_counter() - t1)

    def spread(arrs, name):
        devs = {s.device for x in arrs for s in x.addressable_shards}
        log(f"{name}: shards on {sorted(str(d) for d in devs)}")
        if len(devs) != 4:
            raise SystemExit(f"{name} placed its shards on {len(devs)} "
                             f"device(s)")

    one = jax.device_put(host, jax.devices()[0])
    ref = timed(lambda: levenberg_marquardt_jit(one, **bench.SOLVE_OPTS))
    log("one card " + json.dumps(ref))
    del one

    # Each step logs before it starts, so a run cut at its time limit
    # shows which one it was in: the first collective, a compilation or
    # a solve.
    mesh = make_mesh(4)
    log("collectives: psum over the 4 cards")
    t1 = time.perf_counter()
    total = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(x, "obs"), mesh=mesh,
        in_specs=jax.P("obs"), out_specs=jax.P()))(jnp.ones((4,)))
    if float(jax.block_until_ready(total)[0]) != 4.0:
        raise SystemExit(f"psum over 4 cards gave {total}")
    log(f"collectives ok ({time.perf_counter() - t1:.1f} s)")

    sp = shard_problem_spmd(host, 4, mesh=mesh)
    spread([sp.arrays.cam_idx, sp.arrays.points], "shard_problem_spmd")
    log("shard_map: solving (compilation included)")
    got_s = timed(lambda: levenberg_marquardt_spmd(sp, mesh,
                                                   **bench.SOLVE_OPTS))
    log("shard_map " + json.dumps(got_s))
    del sp

    gspmd = shard_problem(host, mesh)
    spread([gspmd.cam_idx, gspmd.pt2d], "make_array_from_callback")
    log("gspmd: compiling")
    t1 = time.perf_counter()
    compile_lm(gspmd, **bench.SOLVE_OPTS)
    log(f"gspmd: compiled in {time.perf_counter() - t1:.1f} s; solving")
    got_g = timed(lambda: levenberg_marquardt_jit(gspmd, **bench.SOLVE_OPTS))
    log("gspmd " + json.dumps(got_g))

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    log(json.dumps({"peak_bytes_in_use": peaks}))
    for name, got in (("gspmd", got_g), ("shard_map", got_s)):
        rel = abs(got["objective"] - ref["objective"]) / ref["objective"]
        ok = (got["status"] == ref["status"]
              and abs(got["iterations"] - ref["iterations"]) <= 1
              and rel <= FOUR_RTOL)
        log(f"{name} vs one card: objective rel diff {rel:.3e} "
            f"(bound {FOUR_RTOL})")
        if not ok:
            raise SystemExit(f"{name} four-card solve disagrees with the "
                             f"one-card solve")
    done("four cards", t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card comparison")
    args = ap.parse_args(argv)

    import jax
    import bench
    from bundleadjustment_jl_tpu.benchmark import parity
    from bundleadjustment_jl_tpu.utils.cache import configure_compile_cache
    log(f"compile cache: {configure_compile_cache()}")

    want = 4 if args.four else 1
    info = device_phase(want)
    if args.four:
        four_phase()
        info["count"] = 4
    else:
        # the f64 CPU solve runs in a child beside the GPU phases
        import concurrent.futures as cf
        pool = cf.ThreadPoolExecutor(max_workers=1)
        cpu_ref = pool.submit(parity.cpu_f64_solve, parity.LADYBUG49)
        problem = jax.block_until_ready(
            jax.device_put(bench.dubrovnik(seed=0)))
        compile_phase(problem)
        stage_phase(problem)
        solve_phase(cpu_ref.result)
        pool.shutdown()
        del problem
        entry_phase()
        chip_test_phase()
        info["count"] = len(jax.devices())
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
