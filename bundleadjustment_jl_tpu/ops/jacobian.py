"""Batched analytic Jacobian blocks of the BAL reprojection residual.

Heir of the reference's hand-coded Jacobian chain
(`/root/reference/src/JacobianByHand.jl:27-101` — ``JP1!``/``JP2!``/``JP3!``)
and its per-observation 2x12 product ``JP3(2x5) @ JP2(5x6) @ JP1(6x12)``
(`src/BALNLPModels.jl:161-206`, ``jac_coord!``). Instead of scattering 24
COO values per observation into a general sparse matrix, we keep the natural
block structure as two dense batched arrays:

    Jc  (nobs_pad, 2, 9)  d residual / d camera params
    Jp  (nobs_pad, 2, 3)  d residual / d point coords

which downstream ops (`ops/normal.py`, `ops/schur.py`) consume directly as
batched einsums — no sparse scatter, no COO indices.

All stages are closed-form (chain rule through P1 = R(r)X + t,
P2 = -P1[:2]/P1[3], proj = f*rho(P2)*P2) with an AD-safe theta->0 branch
(the reference divides by theta unguarded and zeroes NaNs afterwards,
`BALNLPModels.jl:199-201`). ``jacobian_blocks_ad`` is the `jax.jacfwd`
cross-check playing the role of the reference's `src/AD.jl:32-56`.

Everything here is pure batched array code: one fused XLA computation per
call, no Python loops, static shapes (padded rows are zero-weighted).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.camera import project
from bundleadjustment_jl_tpu.models.problem import BAProblem

# Every batched 3x3 / 2x3 product of the chain runs at full f32: in TF32
# (the card's default for f32 products) the Jacobian blocks would carry
# ~1e-3 relative error into H = J'J, the gradient and the CG matvec,
# which is not acceptable for the Gauss-Newton step.
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

# Same guard as models.camera: below this squared rotation angle use the
# 2nd-order Taylor forms (exact to ~eps there, AD-safe at exactly 0).
_SMALL_THETA_SQ = 1e-24


def _hat(v: jnp.ndarray) -> jnp.ndarray:
    """Batched cross-product (skew) matrix: ``_hat(v) @ u == cross(v, u)``.

    v: (..., 3) -> (..., 3, 3).
    """
    zeros = jnp.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        jnp.stack([zeros, -vz, vy], axis=-1),
        jnp.stack([vz, zeros, -vx], axis=-1),
        jnp.stack([-vy, vx, zeros], axis=-1),
    ], axis=-2)


def _outer(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return a[..., :, None] * b[..., None, :]


def _rotation_and_dr(r: jnp.ndarray, X: jnp.ndarray):
    """Batched rotated point and its derivatives.

    Given axis-angle ``r`` (N,3) and points ``X`` (N,3) returns

    - ``RX``  (N,3)    R(r) @ X
    - ``R``   (N,3,3)  the rotation matrix (== d(RX)/dX, `JacobianByHand.jl:33-44`)
    - ``D``   (N,3,3)  d(RX)/dr           (`JacobianByHand.jl:45-56`)

    Closed form via Rodrigues: with theta=|r|, k=r/theta,
    ``R = cos(t) I + sin(t) [k]_x + (1-cos(t)) k k^T`` and the derivative
    assembled by the chain rule through (theta, k); near theta=0 the exact
    2nd-order Taylor forms are used instead (double-`where` for AD safety).
    """
    n = r.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (n, 3, 3))

    theta_sq = jnp.sum(r * r, axis=-1)                      # (N,)
    safe = theta_sq > _SMALL_THETA_SQ
    theta = jnp.sqrt(jnp.where(safe, theta_sq, 1.0))        # guarded
    k = r / theta[:, None]
    c = jnp.cos(theta)[:, None, None]
    s = jnp.sin(theta)[:, None, None]
    kx = _hat(k)

    R_big = c * eye + s * kx + (1.0 - c) * _outer(k, k)

    # --- d(RX)/dr, large-angle branch --------------------------------------
    # d theta/dr = k^T ;  dk/dr = (I - k k^T)/theta
    kdX = jnp.sum(k * X, axis=-1)                           # (N,)
    kxX = jnp.cross(k, X)                                   # (N,3)
    P = (eye - _outer(k, k)) / theta[:, None, None]         # dk/dr
    D_big = (
        -s * _outer(X, k)                                   # d(cos t X)
        + c * _outer(kxX, k)                                # d(sin t) (k x X)
        - s * _einsum("nab,nbc->nac", _hat(X), P)        # sin t d(k x X)/dk
        + s * kdX[:, None, None] * _outer(k, k)             # d((1-cos t))(k.X)k
        + (1.0 - c) * _einsum(
            "nab,nbc->nac", _outer(k, X) + kdX[:, None, None] * eye, P)
    )

    # --- theta ~ 0: RX ~ X + r x X + 0.5 r x (r x X) -----------------------
    rxX = jnp.cross(r, X)
    RX_small = X + rxX + 0.5 * jnp.cross(r, rxX)
    R_small = eye + _hat(r) + 0.5 * _einsum("nab,nbc->nac", _hat(r), _hat(r))
    D_small = -_hat(X) - 0.5 * (
        _hat(rxX) + _einsum("nab,nbc->nac", _hat(r), _hat(X)))

    sel = safe[:, None, None]
    RX = jnp.where(safe[:, None],
                   _einsum("nab,nb->na", R_big, X), RX_small)
    R = jnp.where(sel, R_big, R_small)
    D = jnp.where(sel, D_big, D_small)
    return RX, R, D


def residuals_and_jacobian(
    problem: BAProblem, cams=None, points=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused batched residual + Jacobian-block evaluation.

    Returns ``(r, Jc, Jp)`` with shapes (nobs_pad, 2), (nobs_pad, 2, 9),
    (nobs_pad, 2, 3); all three are multiplied by the observation weight so
    padded rows contribute exactly zero everywhere downstream.

    One pass computes what the reference does in two threaded loops
    (``residuals!`` `BALNLPModels.jl:39-55` and ``jac_coord!``
    `BALNLPModels.jl:161-206`); XLA fuses the whole chain.
    """
    from bundleadjustment_jl_tpu.ops.gatherfree import take_cam, take_pnt
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    c = take_cam(cams, problem.cam_idx)
    X = take_pnt(points, problem.pnt_idx, problem.pnt_starts,
                 problem.pnt_perm)
    return rj_gathered(c, X, problem.pt2d, problem.w)


def rj_raw(cams, points, cam_idx, pnt_idx, pt2d, w):
    """residuals_and_jacobian on raw observation arrays (any leading
    shape); used by the chunked assembly scan (native gathers — per-chunk
    index vectors carry no global sorted-segment metadata)."""
    return rj_gathered(cams[cam_idx], points[pnt_idx], pt2d, w)


def rj_gathered(c, X, pt2d, w):
    """The linearization chain on pre-gathered per-observation rows
    ``c`` (N, 9) and ``X`` (N, 3)."""

    r_aa, t = c[:, 0:3], c[:, 3:6]
    k1, k2, f = c[:, 6], c[:, 7], c[:, 8]

    # Stage 1: P1 = R(r) X + t ; dP1/dX = R ; dP1/dr = D ; dP1/dt = I.
    RX, R, D = _rotation_and_dr(r_aa, X)
    p1 = RX + t

    # Stage 2: p2 = -p1[:2]/z  (`JacobianByHand.jl:62-77`, JP2!).
    z = p1[:, 2]
    z_safe = jnp.where(z == 0.0, 1.0, z)
    inv_z = 1.0 / z_safe
    p2 = -p1[:, 0:2] * inv_z[:, None]
    # A = dp2/dp1 (N,2,3): [[-1/z, 0, x/z^2], [0, -1/z, y/z^2]].
    zeros = jnp.zeros_like(z)
    A = jnp.stack([
        jnp.stack([-inv_z, zeros, p1[:, 0] * inv_z * inv_z], axis=-1),
        jnp.stack([zeros, -inv_z, p1[:, 1] * inv_z * inv_z], axis=-1),
    ], axis=-2)

    # Stage 3: proj = f * rho(p2) * p2, rho = 1 + k1 n2 + k2 n2^2
    # (`JacobianByHand.jl:80-101`, JP3!).
    n2 = jnp.sum(p2 * p2, axis=-1)
    rho = 1.0 + k1 * n2 + k2 * n2 * n2
    proj = (f * rho)[:, None] * p2
    # B = dproj/dp2 (N,2,2) = f * (rho I + (2 k1 + 4 k2 n2) p2 p2^T)
    eye2 = jnp.broadcast_to(jnp.eye(2, dtype=p2.dtype), A.shape[:1] + (2, 2))
    B = f[:, None, None] * (
        rho[:, None, None] * eye2
        + (2.0 * k1 + 4.0 * k2 * n2)[:, None, None] * _outer(p2, p2))
    # d proj / d (k1, k2, f) (N,2,3): columns f*n2*p2, f*n2^2*p2, rho*p2.
    J_dist = jnp.stack([
        (f * n2)[:, None] * p2,
        (f * n2 * n2)[:, None] * p2,
        rho[:, None] * p2,
    ], axis=-1)

    BA_ = _einsum("nij,njk->nik", B, A)                  # (N,2,3)
    Jp = _einsum("nij,njk->nik", BA_, R)                 # (N,2,3)
    Jr = _einsum("nij,njk->nik", BA_, D)                 # (N,2,3) d/dr
    Jc = jnp.concatenate([Jr, BA_, J_dist], axis=-1)        # (N,2,9)

    res = proj - pt2d

    # z == 0: the reference produces NaN and zeroes it (`BALNLPModels.jl:199-201`);
    # we zero the whole observation explicitly.
    valid = (z != 0.0).astype(res.dtype) * w                # (N,)
    res = res * valid[:, None]
    Jc = Jc * valid[:, None, None]
    Jp = Jp * valid[:, None, None]
    return res, Jc, Jp


# ---------------------------------------------------------------------------
# AD cross-check (the role of the reference's `src/AD.jl:32-56`)
# ---------------------------------------------------------------------------

_jac_single = jax.jacfwd(project, argnums=(0, 1))
_jac_batch = jax.vmap(_jac_single, in_axes=(0, 0))


def jacobian_blocks_ad(problem: BAProblem, cams=None, points=None):
    """Jacobian blocks via `jax.jacfwd` of the projection (12 forward
    tangents per observation). Used to validate the analytic blocks; also a
    perfectly serviceable fallback path."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    c = cams[problem.cam_idx]
    X = points[problem.pnt_idx]
    Jc, Jp = _jac_batch(c, X)
    w = problem.w[:, None, None]
    return Jc * w, Jp * w
