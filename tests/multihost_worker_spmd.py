"""Worker process for the 2-process spmd-driver test.

Launched by tests/test_multihost.py as

    python multihost_worker_spmd.py <coordinator_addr> <num_processes> <pid>

Same shape as `multihost_worker.py`, but through the SECOND multi-chip
layout: `shard_problem_spmd` + `levenberg_marquardt_spmd` — the whole
LM loop inside one `shard_map` with explicit camera-space psums
(`ops/spmdctx.py`). The collective layout (what this test proves) is
the one a multi-host GPU run uses, with the network carrying the psums
across hosts.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import jax.numpy as jnp

    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.parallel.mesh import make_mesh
    from bundleadjustment_jl_tpu.parallel.spmd import shard_problem_spmd
    from bundleadjustment_jl_tpu.solver.lm_jit import STATUS_NAMES
    from bundleadjustment_jl_tpu.solver.lm_spmd import (
        levenberg_marquardt_spmd)

    problem, _ = synthetic_bal(ncams=6, npnts=64, obs_per_pnt=3,
                               noise_px=0.5, perturb=1e-2, seed=7,
                               dtype=jnp.float32, pad_obs_to=128)
    mesh = make_mesh()  # all global devices (one per process)
    sp = shard_problem_spmd(problem, nproc, mesh=mesh)
    res = levenberg_marquardt_spmd(sp, mesh, max_iters=10,
                                   lam0_mode="diag")
    # objective/iterations replicated; points reassembled via allgather
    assert res.points.shape == (problem.npnts, 3)
    print(f"RESULT {float(res.objective):.10e} {int(res.iterations)} "
          f"{STATUS_NAMES[int(res.status)]}", flush=True)


if __name__ == "__main__":
    main()
