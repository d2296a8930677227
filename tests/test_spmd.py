"""Multi-device shard_map solve (`solver/lm_spmd.py`) on a virtual mesh.

The spmd driver runs the SAME `_lm_*_impl` body as the single-device jit
driver inside one shard_map, with `ops/spmdctx.py` psums at the
camera-space reduction points — so a sharded solve must match the
single-device solve step for step (identical lambda schedule and
acceptance decisions; floating-point reassociation across shards is the
only difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.parallel.spmd import shard_problem_spmd
from bundleadjustment_jl_tpu.solver.lm_jit import levenberg_marquardt_jit
from bundleadjustment_jl_tpu.solver.lm_spmd import levenberg_marquardt_spmd


def _mesh(n):
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.asarray(devs[:n]), ("obs",))


def _problem(seed=3):
    prob, _ = synthetic_bal(ncams=11, npnts=400, obs_per_pnt=4, seed=seed,
                            dtype=jnp.float32, perturb=2e-2, noise_px=1.0)
    return prob


def test_shard_builder_roundtrip():
    prob = _problem()
    sp = shard_problem_spmd(prob, 4)
    assert sp.ndev == 4
    assert int(sp.npnts_loc.sum()) == prob.npnts
    assert int(sp.nobs_loc.sum()) == prob.nobs
    # every shard's rows reference only its own points, in local ids
    arrs = sp.arrays
    for d in range(4):
        w = np.asarray(arrs.w[d])
        pi = np.asarray(arrs.pnt_idx[d])[w > 0]
        assert pi.min() >= 0 and pi.max() < sp.npnts_loc[d]
    # global point array reassembles exactly
    got = np.asarray(sp.global_points(np.asarray(arrs.points)))
    np.testing.assert_array_equal(got, np.asarray(prob.points))
    # per-shard padded row counts are uniform multiples of 128
    assert arrs.cam_idx.shape[1] % 128 == 0


@pytest.mark.parametrize("ndev", [2, 8])
def test_spmd_solve_matches_single_device(ndev):
    mesh = _mesh(ndev)
    prob = _problem()
    opts = dict(max_iters=25, pcg_max_iters=60, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                oatol=0.0, ortol=1e-4)
    ref = levenberg_marquardt_jit(prob, **opts)
    sp = shard_problem_spmd(prob, ndev, mesh=mesh)
    got = levenberg_marquardt_spmd(sp, mesh, **opts)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.status) == int(ref.status)
    robj = float(ref.objective)
    assert abs(float(got.objective) - robj) <= 1e-4 * max(1.0, robj)
    # state parity (f32; reassociated sums across shards)
    np.testing.assert_allclose(np.asarray(got.cams),
                               np.asarray(ref.cams), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.points),
                               np.asarray(ref.points), rtol=1e-3, atol=1e-3)


def test_spmd_linesearch_and_facto():
    """Options plumb through: batched linesearch + bf16 W storage."""
    mesh = _mesh(4)
    prob = _problem(seed=9)
    opts = dict(max_iters=15, pcg_max_iters=60, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                oatol=0.0, ortol=1e-4, linesearch=True,
                facto_dtype=jnp.bfloat16)
    ref = levenberg_marquardt_jit(prob, **opts)
    sp = shard_problem_spmd(prob, 4, mesh=mesh)
    got = levenberg_marquardt_spmd(sp, mesh, **opts)
    robj = float(ref.objective)
    # bf16 W perturbs the Schur complement by O(eps(bf16)=2^-8) and the
    # spmd driver reassociates the psum'd reductions, so the two solves
    # legitimately take different PCG trajectories (breakdown-stop makes
    # the iteration count sensitive to those last-bit differences).  Both
    # converge to the instance noise floor; assert agreement at the bf16
    # scale rather than demanding one shared trajectory.
    assert abs(float(got.objective) - robj) <= 5e-3 * max(1.0, robj)


def test_spmd_xla_path_matches_single_device():
    """The spmd driver's local XLA scatter path under the sharding layout
    — the psum hooks in `ops/normal.py` / `ops/schur.py` must make it
    match the single-device XLA solve decision for decision."""
    mesh = _mesh(4)
    prob = _problem()
    opts = dict(max_iters=25, pcg_max_iters=60, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                oatol=0.0, ortol=1e-4)
    ref = levenberg_marquardt_jit(prob, **opts)
    sp = shard_problem_spmd(prob, 4, mesh=mesh)
    got = levenberg_marquardt_spmd(sp, mesh, **opts)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.status) == int(ref.status)
    robj = float(ref.objective)
    assert abs(float(got.objective) - robj) <= 1e-4 * max(1.0, robj)
    np.testing.assert_allclose(np.asarray(got.cams),
                               np.asarray(ref.cams), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.points),
                               np.asarray(ref.points), rtol=1e-3, atol=1e-3)


def test_spmd_facto_bf16_matches_f32():
    """The reference's facto_type mode on the multi-chip path: bf16 W
    storage inside the f32 LM must converge to the same objective."""
    mesh = _mesh(4)
    prob = _problem(seed=3)
    sp = shard_problem_spmd(prob, 4, mesh=mesh)
    opts = dict(max_iters=15, lam0_mode="diag")
    rb = levenberg_marquardt_spmd(sp, mesh, facto_dtype=jnp.bfloat16,
                                  **opts)
    rf = levenberg_marquardt_spmd(sp, mesh, **opts)
    fobj = float(rf.objective)
    assert abs(float(rb.objective) - fobj) <= 1e-2 * max(1.0, fobj)


def test_spmd_float64_matches_jit_float64():
    """f64 runs under both spmd drivers (the reference's working type)
    and matches the single-device f64 solve."""
    from bundleadjustment_jl_tpu.solver.lm_spmd import (
        levenberg_marquardt_spmd, levenberg_marquardt_spmd_chunked)
    mesh = _mesh(2)
    prob, _ = synthetic_bal(ncams=4, npnts=30, obs_per_pnt=3, seed=1,
                            dtype=jnp.float64, perturb=2e-2)
    opts = dict(max_iters=20, lam0_mode="diag")
    ref = levenberg_marquardt_jit(prob, **opts)
    sp = shard_problem_spmd(prob, 2, mesh=mesh)
    for got in (levenberg_marquardt_spmd(sp, mesh, **opts),
                levenberg_marquardt_spmd_chunked(sp, mesh, chunk_iters=4,
                                                 **opts)):
        assert got.objective.dtype == jnp.float64
        assert int(got.iterations) == int(ref.iterations)
        robj = float(ref.objective)
        assert abs(float(got.objective) - robj) <= 1e-9 * max(1.0, robj)


def test_spmd_chunked_matches_and_resumes(tmp_path):
    """Chunked spmd == one-shot spmd; checkpoint/resume continues the
    same solve (state crosses the shard_map boundary between segments)."""
    from bundleadjustment_jl_tpu.solver.lm_spmd import (
        levenberg_marquardt_spmd_chunked)
    mesh = _mesh(4)
    prob = _problem(seed=5)
    opts = dict(max_iters=20, pcg_max_iters=60, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5,
                oatol=0.0, ortol=1e-4)
    sp = shard_problem_spmd(prob, 4, mesh=mesh)
    ref = levenberg_marquardt_spmd(sp, mesh, **opts)
    got = levenberg_marquardt_spmd_chunked(sp, mesh, chunk_iters=3,
                                           **opts)
    assert int(got.iterations) == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(float(got.objective) - robj) <= 1e-5 * max(1.0, robj)

    # checkpoint at every chunk, stop early via max_iters, resume
    ck = str(tmp_path / "ck")
    part = levenberg_marquardt_spmd_chunked(
        sp, mesh, chunk_iters=3, checkpoint_dir=ck,
        **{**opts, "max_iters": 6})
    assert int(part.iterations) == 6
    resumed = levenberg_marquardt_spmd_chunked(
        sp, mesh, chunk_iters=3, checkpoint_dir=ck, resume=True,
        **opts)
    assert int(resumed.iterations) >= 6
    assert abs(float(resumed.objective) - robj) <= 1e-3 * max(1.0, robj)
