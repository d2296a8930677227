"""Bundle-adjustment problem container.

Accelerator data layout: structure-of-arrays with **static, padded shapes** so
a single compiled XLA program serves the whole solve.

- ``cams``    (ncams, 9)  camera params ``(rx,ry,rz,tx,ty,tz,k1,k2,f)``
- ``points``  (npnts, 3)  world points
- ``cam_idx`` (nobs_pad,) int32 camera index per observation
- ``pnt_idx`` (nobs_pad,) int32 point index per observation
- ``pt2d``    (nobs_pad, 2) observed image points
- ``w``       (nobs_pad,) observation weight; 0.0 marks padding, so padded
  rows contribute exactly zero to residual norms, gradients and Hessians.

This replaces the reference's flat variable vector + COO index vectors
(`/root/reference/src/BALNLPModels.jl:79-106`, `src/ReadFiles.jl:16-30`).
The reference stores variables points-first in one flat vector
(``x0 = [X_1..X_npnts, C_1..C_ncams]``, `ReadFiles.jl:29-30`);
:meth:`BAProblem.flatten_state` / :meth:`BAProblem.unflatten_state` provide
that layout for cross-checks and warm starts.

The container is registered as a JAX pytree: array fields are leaves, counts
and name are static aux data, so a ``BAProblem`` can be passed straight into
``jit``ed functions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BAProblem:
    cams: jnp.ndarray      # (ncams, 9)
    points: jnp.ndarray    # (npnts, 3)
    cam_idx: jnp.ndarray   # (nobs_pad,) int32
    pnt_idx: jnp.ndarray   # (nobs_pad,) int32
    pt2d: jnp.ndarray      # (nobs_pad, 2)
    w: jnp.ndarray         # (nobs_pad,)
    nobs: int              # true (unpadded) observation count
    name: str = "ba"
    # Sorted-layout metadata (None when unavailable): `pnt_starts`
    # (npnts+1,) delimits point segments of the rows permuted by `pnt_perm`
    # (None = rows are already point-sorted, the `from_arrays` layout);
    # `cam_perm` (nobs_pad,) permutes rows into cam-sorted order delimited
    # by `cam_starts` (ncams+1,). Enables scatter-free segment sums
    # (`ops/segsum.py`) and the point-aligned spmd shards.
    pnt_starts: jnp.ndarray | None = None
    cam_perm: jnp.ndarray | None = None
    cam_starts: jnp.ndarray | None = None
    pnt_perm: jnp.ndarray | None = None

    # ----- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        leaves = (self.cams, self.points, self.cam_idx, self.pnt_idx,
                  self.pt2d, self.w, self.pnt_starts, self.cam_perm,
                  self.cam_starts, self.pnt_perm)
        aux = (self.nobs, self.name)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        (cams, points, cam_idx, pnt_idx, pt2d, w, pnt_starts, cam_perm,
         cam_starts, pnt_perm) = leaves
        nobs, name = aux
        return cls(cams, points, cam_idx, pnt_idx, pt2d, w, nobs, name,
                   pnt_starts, cam_perm, cam_starts, pnt_perm)

    # ----- construction ----------------------------------------------------
    @classmethod
    def from_arrays(cls, cams, points, cam_idx, pnt_idx, pt2d,
                    dtype=jnp.float64, pad_obs_to: int = 128,
                    name: str = "ba") -> "BAProblem":
        """Build a padded problem from host arrays (0-based indices)."""
        cams = np.asarray(cams, dtype=dtype).reshape(-1, 9)
        points = np.asarray(points, dtype=dtype).reshape(-1, 3)
        cam_idx = np.asarray(cam_idx, dtype=np.int32).ravel()
        pnt_idx = np.asarray(pnt_idx, dtype=np.int32).ravel()
        pt2d = np.asarray(pt2d, dtype=dtype).reshape(-1, 2)
        nobs = cam_idx.shape[0]
        if not (pnt_idx.shape[0] == nobs and pt2d.shape[0] == nobs):
            raise ValueError("inconsistent observation arrays")
        if nobs and (cam_idx.max() >= cams.shape[0] or pnt_idx.max() >= points.shape[0]):
            raise ValueError("observation index out of range")
        ncams, npnts = cams.shape[0], points.shape[0]
        # Sort observations by point (stable) — the layout `ops/segsum.py`
        # exploits for scatter-free reductions. Padding rows carry the max
        # segment ids (zero-weighted, so they sum to nothing).
        order = np.argsort(pnt_idx, kind="stable")
        # np.take: fancy indexing is ~65x slower on this numpy build
        cam_idx = np.take(cam_idx, order)
        pnt_idx = np.take(pnt_idx, order)
        pt2d = np.take(pt2d, order, axis=0)

        npad = _round_up(max(nobs, 1), pad_obs_to)
        w = np.zeros((npad,), dtype=dtype)
        w[:nobs] = 1.0
        ci = np.full((npad,), max(ncams - 1, 0), dtype=np.int32)
        pi = np.full((npad,), max(npnts - 1, 0), dtype=np.int32)
        xy = np.zeros((npad, 2), dtype=dtype)
        ci[:nobs] = cam_idx
        pi[:nobs] = pnt_idx
        xy[:nobs] = pt2d

        from bundleadjustment_jl_tpu.ops.segsum import make_starts
        pnt_starts = make_starts(pi, npnts, npad)
        cam_perm = np.argsort(ci, kind="stable").astype(np.int32)
        cam_starts = make_starts(np.take(ci, cam_perm), ncams, npad)
        return cls(jnp.asarray(cams), jnp.asarray(points), jnp.asarray(ci),
                   jnp.asarray(pi), jnp.asarray(xy), jnp.asarray(w),
                   nobs=nobs, name=name,
                   pnt_starts=jnp.asarray(pnt_starts),
                   cam_perm=jnp.asarray(cam_perm),
                   cam_starts=jnp.asarray(cam_starts))

    # ----- sizes ------------------------------------------------------------
    @property
    def ncams(self) -> int:
        return self.cams.shape[0]

    @property
    def npnts(self) -> int:
        return self.points.shape[0]

    @property
    def nobs_pad(self) -> int:
        return self.cam_idx.shape[0]

    @property
    def nvar(self) -> int:
        """9*ncams + 3*npnts (`BALNLPModels.jl:95`)."""
        return 9 * self.ncams + 3 * self.npnts

    @property
    def nequ(self) -> int:
        """2*nobs (`BALNLPModels.jl:97`)."""
        return 2 * self.nobs

    @property
    def dtype(self):
        return self.cams.dtype

    def astype(self, dtype) -> "BAProblem":
        return BAProblem(self.cams.astype(dtype), self.points.astype(dtype),
                         self.cam_idx, self.pnt_idx, self.pt2d.astype(dtype),
                         self.w.astype(dtype), self.nobs, self.name,
                         self.pnt_starts, self.cam_perm, self.cam_starts,
                         self.pnt_perm)

    # ----- state <-> reference flat layout ----------------------------------
    def state(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return self.cams, self.points

    def with_state(self, cams, points) -> "BAProblem":
        return BAProblem(cams, points, self.cam_idx, self.pnt_idx, self.pt2d,
                         self.w, self.nobs, self.name,
                         self.pnt_starts, self.cam_perm, self.cam_starts,
                         self.pnt_perm)

    def flatten_state(self, cams=None, points=None) -> jnp.ndarray:
        """Flat vector in the reference's points-first layout
        (`ReadFiles.jl:29-30`): ``[X_1..X_npnts, C_1..C_ncams]``."""
        cams = self.cams if cams is None else cams
        points = self.points if points is None else points
        return jnp.concatenate([points.reshape(-1), cams.reshape(-1)])

    def unflatten_state(self, x: jnp.ndarray):
        np3 = 3 * self.npnts
        points = x[:np3].reshape(self.npnts, 3)
        cams = x[np3:].reshape(self.ncams, 9)
        return cams, points
