"""SORTED_MODE segment reductions on sharded and partitioned layouts.

VERDICT r1 #7: `shard_problem`/`partition_problem` used to drop the
sorted-layout metadata, making the scan-based reductions unusable exactly
where they matter. These tests pin
the metadata flow: SORTED_MODE solves must agree with scatter-mode solves
on (a) an 8-way sharded problem and (b) a camera-partitioned problem
(which needs the `pnt_perm` permutation — rows are no longer globally
point-sorted there).
"""

import numpy as np
import pytest

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.ops import segsum
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks
from bundleadjustment_jl_tpu.parallel.mesh import make_mesh, shard_problem
from bundleadjustment_jl_tpu.parallel.partition import partition_problem


@pytest.fixture
def problem():
    p, _ = synthetic_bal(ncams=8, npnts=64, obs_per_pnt=4, noise_px=0.3,
                         perturb=2e-3, seed=33, pad_obs_to=128)
    return p


@pytest.fixture(autouse=True)
def _restore():
    old = segsum.SORTED_MODE
    yield
    segsum.SORTED_MODE = old


def _blocks_close(b1, b2, tol=1e-9):
    np.testing.assert_allclose(np.asarray(b1.g_c), np.asarray(b2.g_c),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(b1.g_p), np.asarray(b2.g_p),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(b1.Hcc), np.asarray(b2.Hcc),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(b1.Hpp), np.asarray(b2.Hpp),
                               rtol=tol, atol=tol)


def test_sharded_problem_carries_metadata(problem):
    sharded = shard_problem(problem, make_mesh(8))
    assert sharded.pnt_starts is not None
    assert sharded.cam_perm is not None
    assert sharded.cam_starts is not None


def test_sorted_mode_matches_scatter_on_sharded(problem):
    sharded = shard_problem(problem, make_mesh(8))
    b_scatter = assemble_blocks(sharded)
    segsum.SORTED_MODE = True
    b_sorted = assemble_blocks(sharded)
    _blocks_close(b_scatter, b_sorted)


def test_sorted_mode_matches_scatter_on_partitioned(problem):
    part, _ = partition_problem(problem, 4)
    assert part.pnt_perm is not None       # rows not globally point-sorted
    b_scatter = assemble_blocks(part)
    segsum.SORTED_MODE = True
    b_sorted = assemble_blocks(part)
    _blocks_close(b_scatter, b_sorted)


def test_partitioned_solution_matches_original(problem):
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        levenberg_marquardt_jit)

    part, _ = partition_problem(problem, 4)
    r1 = levenberg_marquardt_jit(problem, max_iters=25)
    segsum.SORTED_MODE = True
    r2 = levenberg_marquardt_jit(part, max_iters=25)
    assert float(r2.objective) == pytest.approx(float(r1.objective),
                                                rel=1e-6)
