"""Multi-host (multi-process) distributed solve test.

The reference is strictly single-process (`SURVEY.md` §2.3: no
MPI/Distributed deps); multi-host execution is a capability this framework
adds, reached through `jax.distributed.initialize` + GSPMD collectives.
This test proves the claim end-to-end on the CPU backend: two OS processes
(coordinator + worker) form a 2-device global mesh, run the SAME jitted LM
solve over an observation-sharded problem, and must agree with each other
and with a plain single-process solve.
"""

import os
import socket
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_process(worker: str):
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one CPU device per process -> 2 global devices
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_DIR, worker),
             addr, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=_REPO, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line in: {out!r}"
        _, obj, iters, status = lines[-1].split()
        results.append((float(obj), int(iters), status))
    return results


@pytest.mark.skipif(os.environ.get("BA_SUBPROC_TESTS") == "0",
                    reason="subprocess test disabled via env")
def test_two_process_distributed_solve_matches_single():
    results = _run_two_process("multihost_worker.py")

    # both processes see the identical replicated result
    assert results[0] == results[1]

    # single-process reference on the same problem
    import jax
    import jax.numpy as jnp
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, levenberg_marquardt_jit)
    problem, _ = synthetic_bal(ncams=6, npnts=64, obs_per_pnt=3,
                               noise_px=0.5, perturb=1e-2, seed=7,
                               dtype=jnp.float32, pad_obs_to=64)
    res = levenberg_marquardt_jit(problem, max_iters=10, lam0_mode="diag")
    del jax
    obj, iters, status = results[0]
    assert iters == int(res.iterations)
    assert status == STATUS_NAMES[int(res.status)]
    # f32 reduction orders differ between 1- and 2-device partitionings
    assert obj == pytest.approx(float(res.objective), rel=1e-5)


@pytest.mark.skipif(os.environ.get("BA_SUBPROC_TESTS") == "0",
                    reason="subprocess test disabled via env")
def test_two_process_spmd_fused_solve_matches_single():
    """Multi-host proof for the SECOND layout: the spmd driver
    (shard_map + explicit psums) across 2 processes must agree with a
    single-process single-device solve."""
    results = _run_two_process("multihost_worker_spmd.py")
    assert results[0] == results[1]

    import jax.numpy as jnp

    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, levenberg_marquardt_jit)
    problem, _ = synthetic_bal(ncams=6, npnts=64, obs_per_pnt=3,
                               noise_px=0.5, perturb=1e-2, seed=7,
                               dtype=jnp.float32, pad_obs_to=128)
    res = levenberg_marquardt_jit(problem, max_iters=10, lam0_mode="diag")
    obj, iters, status = results[0]
    assert iters == int(res.iterations)
    assert status == STATUS_NAMES[int(res.status)]
    assert obj == pytest.approx(float(res.objective), rel=1e-5)
