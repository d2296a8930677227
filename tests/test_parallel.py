"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
``xla_force_host_platform_device_count=8`` — SURVEY.md §5's prescription for
testing meshes without accelerator hardware). The reference has no distributed
concept at all; these tests pin the sharded path to the single-device one."""

import re

import jax
import numpy as np
import pytest

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks
from bundleadjustment_jl_tpu.ops.residuals import objective
from bundleadjustment_jl_tpu.parallel.mesh import make_mesh, shard_problem
from bundleadjustment_jl_tpu.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.fixture(scope="module")
def problems(mesh):
    problem, _ = synthetic_bal(ncams=8, npnts=64, obs_per_pnt=4,
                               noise_px=0.3, perturb=2e-3, seed=21,
                               pad_obs_to=128)
    return problem, shard_problem(problem, mesh)


def test_sharded_arrays_are_distributed(problems, mesh):
    _, sharded = problems
    assert len(sharded.cam_idx.sharding.device_set) == 8
    assert sharded.cams.sharding.is_fully_replicated


def test_objective_matches_across_shardings(problems):
    single, sharded = problems
    np.testing.assert_allclose(float(objective(single)),
                               float(objective(sharded)), rtol=1e-12)


def test_blocks_match_across_shardings(problems):
    single, sharded = problems
    b1 = assemble_blocks(single)
    b2 = assemble_blocks(sharded)
    np.testing.assert_allclose(np.asarray(b1.g_c), np.asarray(b2.g_c),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(b1.Hpp), np.asarray(b2.Hpp),
                               rtol=1e-10, atol=1e-10)


def test_full_jit_solve_matches_across_shardings(problems):
    single, sharded = problems
    r1 = levenberg_marquardt_jit(single, max_iters=30)
    r2 = levenberg_marquardt_jit(sharded, max_iters=30)
    assert STATUS_NAMES[int(r2.status)] in (
        "first_order", "small_step", "small_residual", "small_obj_change")
    # bitwise-identical control flow is not guaranteed (reduction orders
    # differ across device counts) but the optimum must agree tightly
    np.testing.assert_allclose(float(r2.objective), float(r1.objective),
                               rtol=1e-6)


def test_indivisible_padding_rejected(mesh):
    problem, _ = synthetic_bal(ncams=4, npnts=10, obs_per_pnt=2, seed=22,
                               pad_obs_to=4)  # 20 obs -> pad 20, not % 8
    if problem.nobs_pad % 8 == 0:
        pytest.skip("padding happened to divide")
    with pytest.raises(ValueError):
        shard_problem(problem, mesh)


# Above ops/normal.py:auto_chunk's 2**18 rows one device streams the
# assembly and the Schur diagonal through a lax.scan over observation
# chunks. On a sharded observation axis that scan would all-gather every
# chunk and W to every device; the solver gives sharded problems the
# whole-width forms instead, which need only all-reduces.
_LARGE = dict(ncams=16, npnts=60000, obs_per_pnt=5, noise_px=1.0,
              perturb=2e-2, seed=3, pad_obs_to=512)
_GATHERS = re.compile(
    r"= (\S+) (all-gather|collective-permute|all-to-all)(-start)?\(")


@pytest.fixture(scope="module")
def large():
    from bundleadjustment_jl_tpu.ops.normal import auto_chunk
    problem, _ = synthetic_bal(dtype=np.float32, **_LARGE)
    assert auto_chunk(problem.nobs_pad) is not None
    return problem, shard_problem(problem, make_mesh(4))


def test_obs_sharded_detects_layout(large):
    from bundleadjustment_jl_tpu.solver.lm_jit import _obs_sharded
    single, sharded = large
    assert not _obs_sharded(single)
    assert _obs_sharded(sharded)
    assert not _obs_sharded(shard_problem(single, make_mesh(1)))


@pytest.mark.parametrize("facto", [None, "bfloat16"])
def test_sharded_large_programs_gather_nothing(large, facto):
    from bundleadjustment_jl_tpu.solver.lm_jit import compile_lm
    _, sharded = large
    init, run = compile_lm(sharded, max_iters=3, facto_dtype=facto)
    for name, prog in (("init", init), ("run", run)):
        moved = [m.group(2) + " " + m.group(1)
                 for m in _GATHERS.finditer(prog.as_text())]
        assert not moved, f"{name} program moves observation rows: {moved}"


def test_sharded_large_solve_matches_single(large):
    single, sharded = large
    r1 = levenberg_marquardt_jit(single, max_iters=3)
    r2 = levenberg_marquardt_jit(sharded, max_iters=3)
    assert int(r2.iterations) == int(r1.iterations)
    np.testing.assert_allclose(float(r2.objective), float(r1.objective),
                               rtol=1e-5)
