"""Point-aligned observation sharding for the shard_map solver.

The GSPMD mesh path (`parallel/mesh.py`) shards the observation arrays
and lets XLA partition the scatter/gather formulation. This module
provides the second layout, with explicit collectives
(`solver/lm_spmd.py`):

- **points are split into contiguous ranges** (one per device) chosen so
  each range owns a near-equal number of observations. Because the
  native row layout is point-sorted, each device's rows are a contiguous
  block and every point's rows live on exactly one device — the
  point-direction segment reduction (and back-substitution, and the
  Hpp_inv solve) is **exactly device-local**, no halo exchange.
- **cameras are replicated**; the camera-direction reductions produce
  per-device partials that `psum` over the mesh axis
  (`ops/spmdctx.py`) — SURVEY.md §2.3/§6's prescription for the BA
  "sequence axis".
- each device's shard is padded independently to a **common static row
  count M** (a multiple of 128) and a common local point count PL, so
  one compiled program serves all devices.

Each shard is literally a local :class:`BAProblem` (built by
`BAProblem.from_arrays`, which re-derives the local sorted-layout
metadata), stacked on a leading device axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bundleadjustment_jl_tpu.models.problem import BAProblem

SPMD_AXIS = "obs"


class ShardStack(NamedTuple):
    """Per-device local problem arrays, stacked on a leading D axis.
    ``cams`` is replicated (global camera table); ``pnt_idx`` holds LOCAL
    point ids; padded local points are zero (so norms stay exact)."""
    cams: jnp.ndarray        # (ncams, 9)       replicated
    points: jnp.ndarray      # (D, PL, 3)       local, zero-padded
    cam_idx: jnp.ndarray     # (D, M) int32     global camera ids
    pnt_idx: jnp.ndarray     # (D, M) int32     local point ids
    pt2d: jnp.ndarray        # (D, M, 2)
    w: jnp.ndarray           # (D, M)
    pnt_starts: jnp.ndarray  # (D, PL+1) int32  local row starts
    cam_perm: jnp.ndarray    # (D, M) int32     local cam-sort permutation
    cam_starts: jnp.ndarray  # (D, ncams+1) int32


@dataclasses.dataclass
class SpmdProblem:
    arrays: ShardStack
    point_offsets: np.ndarray   # (D,) global index of each shard's 1st point
    npnts_loc: np.ndarray       # (D,) true local point counts
    nobs_loc: np.ndarray        # (D,) true local row counts
    npnts: int                  # global true point count
    nobs: int                   # global true observation count
    name: str = "ba"

    @property
    def ndev(self) -> int:
        return self.arrays.points.shape[0]

    @property
    def ncams(self) -> int:
        return self.arrays.cams.shape[0]

    def global_points(self, points_stacked) -> jnp.ndarray:
        """(D, PL, 3) solver output -> (npnts, 3) global point array.

        Multi-process: shards owned by other hosts are not addressable;
        all-gather the global value first (host-side, points are small —
        ~10 MB even at Venice scale)."""
        x = points_stacked
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from jax.experimental import multihost_utils
            x = multihost_utils.process_allgather(x, tiled=True)
        parts = [np.asarray(x[d])[:self.npnts_loc[d]]
                 for d in range(self.ndev)]
        return jnp.asarray(np.concatenate(parts, axis=0))

    def split_points(self, points_global) -> jnp.ndarray:
        """(npnts, 3) global point array -> (D, PL, 3) stacked local
        layout (zero-padded) — the inverse of :meth:`global_points`,
        used on checkpoint resume."""
        dt = self.arrays.points.dtype
        pts = np.asarray(points_global, dt).reshape(self.npnts, 3)
        PL = self.arrays.points.shape[1]
        out = np.zeros((self.ndev, PL, 3), pts.dtype)
        for d in range(self.ndev):
            lo = self.point_offsets[d]
            out[d, :self.npnts_loc[d]] = pts[lo:lo + self.npnts_loc[d]]
        return jnp.asarray(out)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_problem_spmd(problem: BAProblem, ndev: int,
                       mesh: Mesh | None = None) -> SpmdProblem:
    """Split a (host or device) problem into ``ndev`` point-aligned shards.

    Rows 0..nobs-1 of the native layout are point-sorted
    (`BAProblem.from_arrays`); the split boundaries are point indices
    chosen greedily for near-equal row counts.
    """
    nobs = problem.nobs
    npnts = problem.npnts
    if npnts < ndev:
        raise ValueError(f"npnts={npnts} < ndev={ndev}")
    cams = np.asarray(problem.cams)
    points = np.asarray(problem.points)
    ci = np.asarray(problem.cam_idx)[:nobs]
    pi = np.asarray(problem.pnt_idx)[:nobs]
    xy = np.asarray(problem.pt2d)[:nobs]
    if np.any(np.diff(pi) < 0):
        raise ValueError("rows are not point-sorted (need the "
                         "from_arrays layout)")

    # Point-range boundaries with near-equal rows per shard.
    cum = np.cumsum(np.bincount(pi, minlength=npnts))      # rows <= point p
    bounds = [0]
    for d in range(1, ndev):
        p = int(np.searchsorted(cum, d * nobs / ndev))
        bounds.append(min(max(p, bounds[-1] + 1), npnts - (ndev - d)))
    bounds.append(npnts)
    row_bounds = [0] + [int(cum[b - 1]) for b in bounds[1:]]

    nobs_loc = np.diff(row_bounds).astype(np.int64)
    M = _round_up(int(nobs_loc.max()), 128)
    npnts_loc = np.diff(bounds).astype(np.int64)
    PL = int(npnts_loc.max())

    dtype = np.asarray(problem.pt2d).dtype
    shards = []
    for d in range(ndev):
        p_lo, p_hi = bounds[d], bounds[d + 1]
        r_lo, r_hi = row_bounds[d], row_bounds[d + 1]
        lp = BAProblem.from_arrays(
            cams, points[p_lo:p_hi], ci[r_lo:r_hi], pi[r_lo:r_hi] - p_lo,
            xy[r_lo:r_hi], dtype=dtype, pad_obs_to=M,
            name=f"{problem.name}/shard{d}")
        # Common static shapes: points zero-padded to PL (keeps norms
        # exact: padded dp stays 0), starts padded with M (empty
        # segments).
        npl = lp.npnts
        pts = np.zeros((PL, 3), dtype)
        pts[:npl] = np.asarray(lp.points)
        starts = np.full((PL + 1,), M, np.int32)
        starts[:npl + 1] = np.asarray(lp.pnt_starts)
        shards.append((pts, np.asarray(lp.cam_idx), np.asarray(lp.pnt_idx),
                       np.asarray(lp.pt2d), np.asarray(lp.w), starts,
                       np.asarray(lp.cam_perm), np.asarray(lp.cam_starts)))

    stack = [np.stack([s[i] for s in shards]) for i in range(8)]
    arrs = ShardStack(jnp.asarray(cams), *map(jnp.asarray, stack))
    if mesh is not None:
        arrs = place_on_mesh(arrs, mesh)
    return SpmdProblem(arrays=arrs,
                       point_offsets=np.asarray(bounds[:-1]),
                       npnts_loc=npnts_loc, nobs_loc=nobs_loc,
                       npnts=npnts, nobs=nobs, name=problem.name)


def place_on_mesh(arrs: ShardStack, mesh: Mesh,
                  axis_name: str = SPMD_AXIS) -> ShardStack:
    """Shard the stacked arrays on their leading device axis (cams
    replicated). Uses make_array_from_callback — multi-process safe,
    like `parallel/mesh.shard_problem`."""
    obs_sh = NamedSharding(mesh, P(axis_name))
    rep_sh = NamedSharding(mesh, P())

    def put(x, sh):
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, sh,
                                            lambda idx: xh[idx])

    return ShardStack(
        put(arrs.cams, rep_sh),
        *[put(getattr(arrs, f), obs_sh) for f in ShardStack._fields[1:]])
