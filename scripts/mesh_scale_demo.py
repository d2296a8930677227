"""Mesh-path scale demonstration at Venice/Final BAL sizes.

Usage: python scripts/mesh_scale_demo.py [preset] [ndev] [max_iters]
  preset: venice  (1350 cams, 894,716 pts, ~4.5M obs)  [default]
          final   (13682 cams, 4,456,117 pts, ~28M obs — the largest BAL
                   problem; the reference never attempted it)

Runs on N virtual CPU devices; the same program runs on N GPUs of one
host when the script is given the GPU platform (``--gpu`` as the fourth
argument).
"""

import os
import sys
import time

preset = sys.argv[1] if len(sys.argv) > 1 else "venice"
ndev = int(sys.argv[2]) if len(sys.argv) > 2 else 4
max_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 3
on_gpu = len(sys.argv) > 4 and sys.argv[4] == "--gpu"

SIZES = {
    "venice": (1350, 894716, 5),
    "final": (13682, 4456117, 6),
}
ncams, npnts, opp = SIZES[preset]

flags = os.environ.get("XLA_FLAGS", "")
if not on_gpu and "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={ndev}").strip()

import jax  # noqa: E402

if not on_gpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundleadjustment_jl_tpu.utils.cache import (  # noqa: E402
    configure_compile_cache)

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal  # noqa: E402
from bundleadjustment_jl_tpu.parallel.mesh import (  # noqa: E402
    make_mesh, shard_problem)
from bundleadjustment_jl_tpu.solver.lm_jit import (  # noqa: E402
    STATUS_NAMES, levenberg_marquardt_jit)


def main():
    configure_compile_cache()
    print(f"preset={preset} devices={len(jax.devices())}", flush=True)
    t0 = time.perf_counter()
    problem, _ = synthetic_bal(
        ncams=ncams, npnts=npnts, obs_per_pnt=opp, noise_px=1.0,
        perturb=2e-2, seed=1, dtype=jnp.float32, pad_obs_to=8192)
    print(f"generated: nobs={problem.nobs} nvar={problem.nvar} "
          f"nequ={problem.nequ} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    sharded = shard_problem(problem, make_mesh(ndev))

    t0 = time.perf_counter()
    res = levenberg_marquardt_jit(
        sharded, max_iters=max_iters, pcg_max_iters=30,
        lam0_mode="diag", satol=0.0, srtol=0.0,
        atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
    jax.block_until_ready(res)
    obj = float(res.objective)
    dt = time.perf_counter() - t0
    nequ = problem.nequ
    print(f"status={STATUS_NAMES[int(res.status)]} "
          f"iters={int(res.iterations)} obj={obj:.6g} "
          f"rmse={(2 * obj / nequ) ** 0.5:.4f}px "
          f"expected_opt={0.5 * (nequ - problem.nvar):.4g} "
          f"wall={dt:.1f}s (incl. compile)", flush=True)
    import numpy as np
    print("obj trace:", np.asarray(res.hist_obj[:int(res.iterations)]),
          flush=True)


if __name__ == "__main__":
    main()
