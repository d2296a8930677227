"""Batched reprojection residuals.

The reference evaluates residuals per observation in a threaded/SIMD scalar
loop (`/root/reference/src/BALNLPModels.jl:39-55`, ``residuals!``) and
subtracts the observed 2D points in ``cons!`` (`BALNLPModels.jl:115-122`).
Here the whole observation axis is one batched computation: gather camera and
point rows, `vmap` the projection, subtract observations — XLA fuses the
chain into one kernel; under `shard_map` the observation axis shards over
the device mesh (the analogue of the reference's `@threads` block
partition, SURVEY.md §2.3).

Residual convention (matches the reference): ``res_k = proj(C_cam(k), X_pnt(k))
- pt2d_k``, weighted by ``w_k`` (0 for padded rows).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.camera import project_valid
from bundleadjustment_jl_tpu.models.problem import BAProblem

_project_batch = jax.vmap(project_valid, in_axes=(0, 0))

# Above this many bytes of gathered per-observation camera rows
# (nobs_pad * 9 * itemsize) the objective streams in GATHER_CHUNK-row
# chunks (`objective_chunked`) instead of gathering the whole width at
# once; `ops/normal.py:inv3x3_damped_flat` applies the same budget to its
# point-block temporaries. No BAL problem reaches it on one 80 GB card
# (Final-13682: ~1 GB of camera rows), so the direct form always runs
# there; the chunked forms are the fallback for larger inputs.
GATHER_DIRECT_MAX_BYTES = 4 << 30
GATHER_CHUNK = 1 << 18


def residuals(problem: BAProblem, cams=None, points=None) -> jnp.ndarray:
    """Weighted residuals, shape (nobs_pad, 2). Padded rows are exactly 0.

    A z == 0 observation is zeroed ENTIRELY (residual, not just projection)
    — the same convention as `ops.jacobian.rj_raw`, so trial and linearized
    objectives always agree on which observations count.
    """
    from bundleadjustment_jl_tpu.ops.gatherfree import take_cam, take_pnt
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    c = take_cam(cams, problem.cam_idx)                   # (nobs_pad, 9)
    X = take_pnt(points, problem.pnt_idx, problem.pnt_starts,
                 problem.pnt_perm)                        # (nobs_pad, 3)
    proj, valid = _project_batch(c, X)   # (nobs_pad, 2), (nobs_pad,)
    w = problem.w * valid.astype(problem.w.dtype)
    return (proj - problem.pt2d) * w[:, None]


def objective(problem: BAProblem, cams=None, points=None) -> jnp.ndarray:
    """0.5 * ||r||^2, the reference's objective (`src/lm.jl:41`)."""
    r = residuals(problem, cams, points)
    return 0.5 * jnp.sum(r * r)


def objective_chunked(problem: BAProblem, cams, points,
                      chunk: int) -> jnp.ndarray:
    """0.5 * ||r||^2 streamed over observation chunks.

    Chunking bounds the ``cams[cam_idx]`` gather to (chunk, 9) per scan
    step; pt2d windows are dynamic-sliced straight from the parameter
    (cf. `ops/normal.py` streaming assembly)."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    n = problem.nobs_pad
    chunk = min(chunk, n)
    nchunks = n // chunk
    nfull = nchunks * chunk

    def piece(ci, pi, xy, w):
        proj, valid = _project_batch(cams[ci], points[pi])
        r = (proj - xy) * (w * valid.astype(w.dtype))[:, None]
        return 0.5 * jnp.sum(r * r)

    def body(acc, x):
        ci, pi, row0, w = x
        xy = jax.lax.dynamic_slice(
            problem.pt2d, (row0, jnp.zeros((), row0.dtype)),
            (chunk, 2))
        return acc + piece(ci, pi, xy, w), None

    xs = (problem.cam_idx[:nfull].reshape(nchunks, chunk),
          problem.pnt_idx[:nfull].reshape(nchunks, chunk),
          jnp.arange(nchunks, dtype=jnp.int32) * chunk,
          problem.w[:nfull].reshape(nchunks, chunk))
    acc, _ = jax.lax.scan(body, jnp.zeros((), cams.dtype), xs)
    if n > nfull:
        acc = acc + piece(problem.cam_idx[nfull:], problem.pnt_idx[nfull:],
                          problem.pt2d[nfull:], problem.w[nfull:])
    return acc
