"""Stage parity of the XLA formulations against the float64 reference
(`benchmark/parity.py`) on the CPU, at small sizes.

``chip_smoke.py`` runs the same comparison on the GPU at Dubrovnik-356;
here every stage is checked for each stored W precision and for both the
whole-width and the chunked/streamed forms, and on edge-case shapes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from bundleadjustment_jl_tpu.benchmark import parity
from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.models.problem import BAProblem


@functools.cache
def _problem():
    p, _ = synthetic_bal(ncams=12, npnts=300, obs_per_pnt=4, noise_px=1.0,
                         perturb=2e-2, seed=11, dtype=jnp.float32)
    return p


@functools.cache
def _errors(facto, branch):
    return parity.worst_by_stage(
        parity.stage_errors(_problem(), facto, branch))


@pytest.mark.parametrize("branch", ["whole", "chunked"])
@pytest.mark.parametrize("facto", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("stage", parity.STAGES)
def test_stage_matches_f64_reference(stage, facto, branch, monkeypatch):
    # "whole": the einsum block products with whole-width assembly,
    # diagonal and objective; "chunked": the flat elementwise products
    # with the streamed forms (`ops/blockmul.py:SMALL_N`)
    from bundleadjustment_jl_tpu.ops import blockmul
    monkeypatch.setattr(blockmul, "SMALL_N",
                        1 << 62 if branch == "whole" else 0)
    err = _errors(facto, branch)[stage]
    assert err <= parity.TOLERANCE[facto], (stage, facto, branch, err)


def test_reference_jacobian_matches_ad():
    """The complex-step Jacobian of the reference agrees with the
    package's analytic blocks (two independent derivations)."""
    from bundleadjustment_jl_tpu.ops.jacobian import residuals_and_jacobian
    p64, _ = synthetic_bal(ncams=5, npnts=40, obs_per_pnt=3, seed=2,
                           dtype=jnp.float64)
    ref = parity.Reference(p64)
    r, Jc, Jp = residuals_and_jacobian(p64)
    np.testing.assert_allclose(np.asarray(Jc), ref.Jc, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(Jp), ref.Jp, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(r), ref.r, rtol=1e-12,
                               atol=1e-9)


def _edge_problem(kind):
    if kind == "one_camera":
        p, _ = synthetic_bal(ncams=1, npnts=60, obs_per_pnt=1, seed=3,
                             dtype=jnp.float32)
        return p
    if kind == "points_seen_once":
        p, _ = synthetic_bal(ncams=6, npnts=80, obs_per_pnt=1, seed=4,
                             dtype=jnp.float32)
        return p
    if kind == "padded_rows":
        p, _ = synthetic_bal(ncams=4, npnts=30, obs_per_pnt=3, seed=6,
                             dtype=jnp.float32, pad_obs_to=512)
        assert p.nobs_pad - p.nobs > 400
        return p
    # empty segments: camera 2 and the last points observe nothing
    src, _ = synthetic_bal(ncams=5, npnts=50, obs_per_pnt=3, seed=7,
                           dtype=np.float64)
    ci = np.asarray(src.cam_idx)[:src.nobs]
    pi = np.asarray(src.pnt_idx)[:src.nobs]
    xy = np.asarray(src.pt2d)[:src.nobs]
    keep = (ci != 2) & (pi < 45)
    return BAProblem.from_arrays(np.asarray(src.cams), np.asarray(src.points),
                                 ci[keep], pi[keep], xy[keep],
                                 dtype=np.float32)


@pytest.mark.parametrize("kind", ["one_camera", "points_seen_once",
                                  "padded_rows", "empty_segments"])
def test_stage_parity_edge_shapes(kind):
    p = _edge_problem(kind)
    errs = parity.worst_by_stage(parity.stage_errors(p, "f32", "whole"))
    assert all(e <= parity.TOLERANCE["f32"] for e in errs.values()), errs


def test_whole_solve_f32_matches_f64_on_cpu():
    """The whole-solve comparison of chip_smoke.py, on the CPU at a small
    size: an f32 solve against the f64 child process."""
    gen = dict(ncams=8, npnts=200, obs_per_pnt=4, noise_px=1.0,
               perturb=2e-2, seed=3, pad_obs_to=128)
    f32 = parity.solve_summary(gen, jnp.float32)
    f64 = parity.cpu_f64_solve(gen)
    assert f64["platform"] == "cpu"
    assert parity.solves_agree(f32, f64), (f32, f64)


def test_precision_controls_on_cpu():
    """The controls of chip_smoke.py: on the CPU the tf32 one is plain
    f32 and sits inside the f32 bound; the bf16-accumulated product
    exceeds the bf16 bound on any device."""
    ref = parity.Reference(_problem())
    errs = parity.precision_controls(ref)
    assert 0.0 < errs["tf32"] <= parity.TOLERANCE["f32"]
    assert errs["bf16_accumulation"] > parity.TOLERANCE["bf16"]
