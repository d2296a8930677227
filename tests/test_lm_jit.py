"""Fully-jitted LM vs the host-stepped driver: same algorithm, one XLA
program. Cross-checks convergence and agreement between the two drivers."""

import numpy as np

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.solver.lm import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu.solver.lm_jit import (
    MAX_ITER, STATUS_NAMES, levenberg_marquardt_jit)


def test_jit_converges_and_matches_host_driver():
    problem, _ = synthetic_bal(ncams=8, npnts=60, obs_per_pnt=3,
                               noise_px=0.4, perturb=2e-3, seed=9)
    host = levenberg_marquardt(problem, LMOptions(solver="pcg",
                                                  max_iters=60,
                                                  pcg_max_iters=200))
    jit = levenberg_marquardt_jit(problem, max_iters=60, pcg_max_iters=200)
    assert STATUS_NAMES[int(jit.status)] in (
        "first_order", "small_step", "small_residual", "small_obj_change")
    assert host.solved()
    np.testing.assert_allclose(float(jit.objective), host.objective,
                               rtol=1e-2)


def test_jit_history_is_recorded():
    problem, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3,
                               noise_px=0.3, perturb=2e-3, seed=10)
    res = levenberg_marquardt_jit(problem, max_iters=40)
    n = int(res.iterations)
    assert n > 0
    objs = np.asarray(res.hist_obj[:n])
    assert np.all(np.isfinite(objs))
    assert objs[0] > float(res.objective)  # made progress
    lams = np.asarray(res.hist_lam[:n])
    assert np.all(lams > 0)


def test_jit_max_iter_status():
    problem, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3,
                               perturb=5e-2, seed=12)
    res = levenberg_marquardt_jit(problem, max_iters=1,
                                  atol=0.0, rtol=0.0, restol=0.0,
                                  satol=0.0, srtol=0.0, oatol=0.0, ortol=0.0)
    assert int(res.status) == MAX_ITER
    assert int(res.iterations) == 1


def test_jit_linesearch_variant():
    problem, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3,
                               noise_px=0.3, perturb=5e-3, seed=13)
    res = levenberg_marquardt_jit(problem, max_iters=60, linesearch=True)
    assert STATUS_NAMES[int(res.status)] in (
        "first_order", "small_step", "small_residual", "small_obj_change")


def test_jit_linesearch_serial_trials_match_vmapped(monkeypatch):
    """Large-problem linesearch path: trial objectives via lax.map must be
    bit-identical to the vmapped evaluation (the vmapped form materializes
    an (S, nobs, 9) gather at full width)."""
    from bundleadjustment_jl_tpu.solver import lm_jit

    problem, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3,
                               noise_px=0.3, perturb=5e-3, seed=13)
    ref = levenberg_marquardt_jit(problem, max_iters=25, linesearch=True)
    # _lm_run is jitted at module scope: clear its cache so the
    # monkeypatched threshold actually retraces the loop body.
    monkeypatch.setattr(lm_jit, "TRIAL_VMAP_MAX_BYTES", 0)
    lm_jit._lm_run.clear_cache()
    lm_jit._lm_init.clear_cache()
    try:
        ser = levenberg_marquardt_jit(problem, max_iters=25, linesearch=True)
    finally:
        lm_jit._lm_run.clear_cache()
        lm_jit._lm_init.clear_cache()
    assert int(ser.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(ser.hist_obj),
                                  np.asarray(ref.hist_obj))


def test_jit_dense_solver_variant():
    problem, _ = synthetic_bal(ncams=5, npnts=30, obs_per_pnt=3,
                               noise_px=0.2, perturb=2e-3, seed=14)
    res = levenberg_marquardt_jit(problem, max_iters=40, use_dense=True)
    assert STATUS_NAMES[int(res.status)] in (
        "first_order", "small_step", "small_residual", "small_obj_change")
