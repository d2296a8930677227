"""Worker process for the 2-process `jax.distributed` test.

Launched by tests/test_multihost.py as

    python multihost_worker.py <coordinator_addr> <num_processes> <proc_id>

Initializes the distributed runtime on the CPU backend, builds the SAME
synthetic problem on every process, shards it over the global 1-D mesh via
`shard_problem` (which uses `make_array_from_callback`, so each process
feeds only its addressable shards), runs a short fully-jitted LM solve, and
prints the final objective — the parent asserts cross-process agreement and
parity with a single-process solve. This exercises the mesh + collective
path the CLI's ``--multihost`` flag enables (`cli.py`), over the same
GSPMD program that runs across the GPUs of several hosts (the network in
place of this test's local gRPC).
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.parallel.mesh import (
        make_mesh, shard_problem)
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, levenberg_marquardt_jit)
    import jax.numpy as jnp

    problem, _ = synthetic_bal(ncams=6, npnts=64, obs_per_pnt=3,
                               noise_px=0.5, perturb=1e-2, seed=7,
                               dtype=jnp.float32, pad_obs_to=64)
    mesh = make_mesh()  # all global devices (one per process)
    sharded = shard_problem(problem, mesh)
    res = levenberg_marquardt_jit(sharded, max_iters=10, lam0_mode="diag")
    # objective/iterations are fully replicated -> addressable everywhere
    print(f"RESULT {float(res.objective):.10e} {int(res.iterations)} "
          f"{STATUS_NAMES[int(res.status)]}", flush=True)


if __name__ == "__main__":
    main()
