"""Multi-device validation at REAL BAL shapes on a virtual CPU mesh.

Runs the multi-device paths at Venice-1778 (4.97M obs) and Final-13682
(31.2M obs) shapes on N virtual CPU devices and checks PARITY against a
single-device solve of the identical problem (`chip_smoke.py --four`
runs the Venice-1778 comparison on four GPUs):

  1. single-device `levenberg_marquardt_jit` (XLA path) — ground truth;
  2. GSPMD: the same jit solve on `parallel/mesh.py` shardings (XLA
     partitions the scatter/gather formulation automatically);
  3. spmd: `solver/lm_spmd.py` — the whole LM loop in ONE shard_map
     over point-aligned shards (`parallel/spmd.py`) with explicit
     camera-space psums (the hooks in ops/normal.py + ops/schur.py).

Parity bar: same iteration count, same status, objective within f32
reassociation tolerance — the spmd drivers run the same traced scalar
control flow, so trajectories must match decision for decision.

Usage: python scripts/multichip_scale.py {venice1778|final13682} [ndev] [iters]
Writes one JSON line per configuration.
"""

import json
import os
import sys
import time

preset = sys.argv[1] if len(sys.argv) > 1 else "venice1778"
ndev = int(sys.argv[2]) if len(sys.argv) > 2 else 4
iters = int(sys.argv[3]) if len(sys.argv) > 3 else 4

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={ndev}").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundleadjustment_jl_tpu.parallel.mesh import (  # noqa: E402
    make_mesh, shard_problem)
from bundleadjustment_jl_tpu.parallel.spmd import (  # noqa: E402
    shard_problem_spmd)
from bundleadjustment_jl_tpu.solver.lm_jit import (  # noqa: E402
    STATUS_NAMES, levenberg_marquardt_jit)
from bundleadjustment_jl_tpu.solver.lm_spmd import (  # noqa: E402
    levenberg_marquardt_spmd)

SIZES = {
    # (ncams, npnts, obs_per_pnt)
    "venice1350": (1350, 894716, 5),
    "venice1778": (1778, 993923, 5),
    "final13682": (13682, 4456117, 7),
}


def main():
    ncams, npnts, opp = SIZES[preset]
    print(f"preset={preset} ndev={ndev} devices={len(jax.devices())} "
          f"iters={iters}", flush=True)
    assert len(jax.devices()) >= ndev

    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    t0 = time.perf_counter()
    problem, _ = synthetic_bal(ncams=ncams, npnts=npnts, obs_per_pnt=opp,
                               noise_px=1.0, perturb=2e-2, seed=1,
                               dtype=np.float32, pad_obs_to=8192)
    print(f"problem: nobs={problem.nobs} nvar={problem.nvar} "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)

    opts = dict(max_iters=iters, pcg_max_iters=40, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                oatol=0.0, ortol=1e-4)
    results = {}

    def record(tag, res, secs):
        row = {"preset": preset, "config": tag, "ndev_used": ndev,
               "iterations": int(res.iterations),
               "status": STATUS_NAMES[int(res.status)],
               "objective": float(res.objective),
               "gnorm": float(res.dual_feas),
               "wall_s": round(secs, 1)}
        results[tag] = row
        print(json.dumps(row), flush=True)

    # 1. single device (first device only)
    t0 = time.perf_counter()
    res1 = levenberg_marquardt_jit(problem, **opts)
    jax.block_until_ready(res1.objective)
    record("single", res1, time.perf_counter() - t0)

    # 2. GSPMD over the mesh
    mesh = make_mesh(ndev)
    sharded = shard_problem(problem, mesh)
    t0 = time.perf_counter()
    res2 = levenberg_marquardt_jit(sharded, **opts)
    jax.block_until_ready(res2.objective)
    record("gspmd", res2, time.perf_counter() - t0)
    del sharded

    # 3. explicit-collective spmd driver
    t0 = time.perf_counter()
    sp = shard_problem_spmd(problem, ndev, mesh=mesh)
    print(f"sharded point ranges: M={sp.arrays.cam_idx.shape[1]} "
          f"PL={sp.arrays.points.shape[1]} "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)
    t0 = time.perf_counter()
    res3 = levenberg_marquardt_spmd(sp, mesh, **opts)
    jax.block_until_ready(res3.objective)
    record("spmd", res3, time.perf_counter() - t0)

    ref = results["single"]
    ok = True
    for tag in ("gspmd", "spmd"):
        row = results[tag]
        dobj = abs(row["objective"] - ref["objective"]) / max(
            1.0, abs(ref["objective"]))
        same = (row["iterations"] == ref["iterations"]
                and row["status"] == ref["status"] and dobj < 1e-3)
        ok = ok and same
        print(f"PARITY {tag}: iters {row['iterations']} vs "
              f"{ref['iterations']}, status {row['status']} vs "
              f"{ref['status']}, rel-dobj {dobj:.2e} -> "
              f"{'OK' if same else 'MISMATCH'}", flush=True)
    print(json.dumps({"preset": preset, "ndev": ndev, "parity_ok": ok}),
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
