"""Tests that need the GPU (marker ``chip``).

They skip on the CPU; ``chip_smoke.py`` runs them on the card
(``pytest -m chip``). Whether a GPU is present is decided inside the
``gpu`` fixture, never at import, so every test worker collects the same
tests.
"""

import jax
import jax.numpy as jnp
import pytest

from bundleadjustment_jl_tpu.benchmark import parity
from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.mark.parametrize("facto", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("branch", ["whole", "chunked"])
def test_stage_parity_on_gpu(gpu, facto, branch, monkeypatch):
    """Both forms of every stage at LadyBug-49 size, on the card: the
    einsum products with the whole-width forms, and the flat products
    (`ops/blockmul.py:SMALL_N`) with the streamed forms."""
    from bundleadjustment_jl_tpu.ops import blockmul
    monkeypatch.setattr(blockmul, "SMALL_N",
                        1 << 62 if branch == "whole" else 0)
    problem, _ = synthetic_bal(ncams=49, npnts=7776, obs_per_pnt=4,
                               noise_px=1.0, perturb=2e-2, seed=1,
                               dtype=jnp.float32, pad_obs_to=512)
    assert problem.cams.devices() == {gpu}
    errs = parity.worst_by_stage(parity.stage_errors(problem, facto,
                                                     branch))
    tol = parity.TOLERANCE[facto]
    assert all(e <= tol for e in errs.values()), errs
