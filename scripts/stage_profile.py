"""Device time of each LM stage at Dubrovnik-356 (f32) on the GPU.

Two measurements, both read from `jax.profiler` traces:

1. one whole f32 solve (`levenberg_marquardt_jit`, bench.py's options):
   device busy time (union of the kernel intervals on the GPU's
   streams), the traced window and the idle share;
2. each stage jitted on its own at the solve's linearization point and
   run ``--reps`` times in a trace of its own: assembly (linearize +
   blocks + W storage cast), reduce+diagonal (`reduce_system` +
   `schur_diag_blocks`), one Schur matvec, back-substitution + quad form,
   one trial objective. Device time per call = busy time / reps.

Each stage also gets the bytes its XLA formulation must move at least
(the byte model below, from shapes) and the resulting share of the
card's 3.35 TB/s. Stage counts per solve (assemblies = accepted steps +
1, CG matvecs = CG iterations + one initial residual per LM iteration)
turn the per-call times into a per-solve breakdown.

    python scripts/stage_profile.py [--reps N] [--out DIR]

Writes ``<out>/stage_profile.json`` (default ``chiprun_out/``) and prints
it. Requires a GPU.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402

PEAK_BYTES_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)


def busy_ns(trace_dir):
    """(busy, window, line names): union of the device kernel intervals
    in the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    spans, names = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            names.add(ln.name)
            spans += [(ev.start_ns, ev.start_ns + ev.duration_ns)
                      for ev in ln.events]
    if not spans:
        raise SystemExit(f"no device events in {path}")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0], sorted(names)


def traced(fn, reps, root, name):
    jax.block_until_ready(fn())                 # compile + warm
    d = os.path.join(root, name)
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        for _ in range(reps):
            jax.block_until_ready(fn())
    wall = time.perf_counter() - t0
    busy, window, lines = busy_ns(d)
    return {"device_ms_per_call": busy / reps / 1e6,
            "wall_ms_per_call": 1e3 * wall / reps,
            "idle_share": 1.0 - busy / window, "lines": lines}


def byte_model(n, npnts, ncams, w_bytes=4):
    """Least bytes each stage's formulation moves per call: per-row
    inputs once, W written once (assembly) or read once per W product,
    per-row gathered operands and the int32 index vectors."""
    idx = 2 * 4 * n
    rows_in = (9 + 3 + 2 + 1) * 4 * n          # gathered cam, pnt, xy, w
    W = 27 * w_bytes * n
    return {
        "assembly": rows_in + idx + W,
        "reduce_diag": 2 * W + idx + (9 + 3) * 4 * n + 81 * 4 * ncams,
        "matvec": 2 * W + 2 * idx + (9 + 3) * 4 * n,
        "backsub_quad": 2 * W + 2 * idx + 2 * (9 + 3) * 4 * n,
        "objective": rows_in + idx,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    bench.require_gpu()
    from bundleadjustment_jl_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    from bundleadjustment_jl_tpu.ops.normal import assemble_blocks
    from bundleadjustment_jl_tpu.ops.schur import (
        back_substitute, quad_form, reduce_system, schur_diag_blocks,
        schur_matvec)
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        _objective, levenberg_marquardt_jit)

    card = bench.gpu_name_and_power()
    problem = jax.block_until_ready(jax.device_put(bench.dubrovnik(seed=0)))
    root = tempfile.mkdtemp(prefix="stage_profile_")

    def solve():
        return levenberg_marquardt_jit(problem, **bench.SOLVE_OPTS)

    res = jax.block_until_ready(solve())
    whole = traced(solve, 1, root, "solve")
    it, acc = int(res.iterations), int(res.naccepts)
    cg = int(jnp.sum(res.hist_cg[:it]))

    assemble = jax.jit(lambda p: assemble_blocks(p, with_jr=False))
    blocks = assemble(problem)
    lam = jnp.asarray(1e-3 * float(jnp.max(blocks.Hcc_f)), jnp.float32)

    def red(p, b, lam):
        s = reduce_system(p, b, lam)
        return s, schur_diag_blocks(s)
    reduce_diag = jax.jit(red)
    sys_, _ = reduce_diag(problem, blocks, lam)
    matvec = jax.jit(schur_matvec)

    def bq(p, b, s, dc):
        dp = back_substitute(s, dc)
        return dp, quad_form(p, b, dc, dp)
    backsub_quad = jax.jit(bq)
    dc = sys_.b * 1e-6
    objective = jax.jit(_objective)
    cams = problem.cams + 1e-6
    points = problem.points + 1e-6

    stages = {
        "assembly": traced(lambda: assemble(problem), args.reps, root,
                           "assembly"),
        "reduce_diag": traced(lambda: reduce_diag(problem, blocks, lam),
                              args.reps, root, "reduce_diag"),
        "matvec": traced(lambda: matvec(sys_, sys_.b), args.reps, root,
                         "matvec"),
        "backsub_quad": traced(lambda: backsub_quad(problem, blocks, sys_,
                                                    dc),
                               args.reps, root, "backsub_quad"),
        "objective": traced(lambda: objective(problem, cams, points),
                            args.reps, root, "objective"),
    }
    counts = {"assembly": acc + 1, "reduce_diag": it, "matvec": cg + it,
              "backsub_quad": it, "objective": it}
    model = byte_model(problem.nobs_pad, problem.npnts, problem.ncams)
    per_solve = {k: counts[k] * v["device_ms_per_call"]
                 for k, v in stages.items()}
    for k, v in stages.items():
        v["bytes_model"] = model[k]
        v["gb_s"] = model[k] / (v["device_ms_per_call"] * 1e-3) / 1e9
        v["share_of_3p35_tb_s"] = v["gb_s"] * 1e9 / PEAK_BYTES_S
        v["calls_per_solve"] = counts[k]
        v["ms_per_solve"] = per_solve[k]
    out = {
        "card": card, "device": bench.device_info(),
        "problem": {"nobs": problem.nobs, "nobs_pad": problem.nobs_pad,
                    "ncams": problem.ncams, "npnts": problem.npnts},
        "solve": {"iterations": it, "accepts": acc, "cg_iterations": cg,
                  "device_ms": whole["device_ms_per_call"],
                  "wall_ms": whole["wall_ms_per_call"],
                  "idle_share": whole["idle_share"],
                  "lines": whole["lines"]},
        "stages": stages,
        "stages_ms_per_solve_total": sum(per_solve.values()),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "stage_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
