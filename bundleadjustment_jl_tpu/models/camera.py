"""Snavely/BAL camera model: Rodrigues rotation + perspective divide (with
negation) + radial distortion.

Semantics match the reference model (`/root/reference/src/BALNLPModels.jl:11-36`
and `src/JacobianByHand.jl:5-24`):

    P1 = R(r) @ X + t            (Rodrigues rotation by axis-angle r)
    P2 = -P1[:2] / P1[2]         (perspective divide, BAL negation convention)
    rho = 1 + k1*|P2|^2 + k2*|P2|^4
    proj = f * rho * P2

Camera parameter vector layout (9,): ``(rx, ry, rz, tx, ty, tz, k1, k2, f)``
— the reference's *internal* order after its reader reorders the BAL file
order ``(r, t, f, k1, k2)`` (`src/ReadFiles.jl:33-42`).

Unlike the reference (which divides by ``theta`` unguarded and relies on NaN
zeroing, cf. the disabled branch `BALNLPModels.jl:20-27`), all functions here
are AD-safe at ``theta -> 0`` via the standard double-`where` trick, so
`jax.jacfwd`/`jax.jacrev` produce finite derivatives everywhere. Every
function is scalar-per-observation and meant to be `vmap`ed / `jit`ed.

Inner products are written as ``sum(a * b)`` rather than ``jnp.dot``: under
`vmap` a 3-vector dot becomes a batched (N,3)x(N,3) dot_general at
default matmul precision (TF32 on the GPU) — a silent precision drop.
Multiply+reduce stays a fused f32 elementwise op.
"""

from __future__ import annotations

import jax.numpy as jnp


def _vdot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)

# Below this squared angle we switch to the 2nd-order Taylor form of the
# rotation, which is exact to ~eps at that scale and AD-safe at 0.
_SMALL_THETA_SQ = 1e-24


def rodrigues_rotate(r: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Rotate 3-vector ``X`` by the axis-angle (Rodrigues) vector ``r``.

    R(r) X = cos(t) X + sin(t) (k x X) + (1 - cos(t)) (k . X) k,
    with t = |r|, k = r/t  (`src/BALNLPModels.jl:19-24`).
    """
    theta_sq = _vdot3(r, r)
    safe = theta_sq > _SMALL_THETA_SQ
    # Double-where: guard the argument *before* the non-differentiable sqrt /
    # division so cotangents stay finite on the untaken branch.
    theta_sq_safe = jnp.where(safe, theta_sq, 1.0)
    theta = jnp.sqrt(theta_sq_safe)
    k = r / theta
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    rotated = c * X + s * jnp.cross(k, X) + (1.0 - c) * _vdot3(k, X) * k
    # theta ~ 0: R X ~ X + r x X + 0.5 * r x (r x X)
    rxX = jnp.cross(r, X)
    small = X + rxX + 0.5 * jnp.cross(r, rxX)
    return jnp.where(safe, rotated, small)


def distortion_factor(p: jnp.ndarray, k1: jnp.ndarray, k2: jnp.ndarray) -> jnp.ndarray:
    """Radial distortion rho(p) = 1 + k1 |p|^2 + k2 |p|^4
    (`src/BALNLPModels.jl:11-14`, `scaling_factor`)."""
    n2 = _vdot3(p, p)
    return 1.0 + k1 * n2 + k2 * n2 * n2


def project_p1(cam: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """First projection stage: camera-frame point ``P1 = R(r) X + t``
    (`src/JacobianByHand.jl:5-12`)."""
    return rodrigues_rotate(cam[0:3], X) + cam[3:6]


def project(cam: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Full BAL projection of world point ``X`` (3,) by camera ``cam`` (9,).

    Returns the predicted 2D image point (2,). Matches
    `src/BALNLPModels.jl:17-33` (``projection!``) including the BAL
    sign convention ``P2 = -P1[:2]/P1[2]``. A point exactly on the camera
    plane (P1.z == 0) is guarded to keep AD finite; the reference instead
    produces NaN and zeroes it downstream (`BALNLPModels.jl:199-201`).
    """
    p1 = project_p1(cam, X)
    z = p1[2]
    z_safe = jnp.where(z == 0.0, 1.0, z)
    p2 = -p1[0:2] / z_safe
    k1, k2, f = cam[6], cam[7], cam[8]
    proj = f * distortion_factor(p2, k1, k2) * p2
    return jnp.where(z == 0.0, jnp.zeros_like(proj), proj)


def project_valid(cam: jnp.ndarray, X: jnp.ndarray):
    """Like :func:`project` but also returns the z != 0 validity flag.

    Residual evaluation zeroes the ENTIRE observation when the point sits on
    the camera plane — the same convention `ops.jacobian.rj_raw` applies to
    residual and Jacobian alike — so trial objectives and linearized
    objectives are computed against the same residual vector.
    """
    p1 = project_p1(cam, X)
    z = p1[2]
    valid = z != 0.0
    z_safe = jnp.where(valid, z, 1.0)
    p2 = -p1[0:2] / z_safe
    k1, k2, f = cam[6], cam[7], cam[8]
    proj = f * distortion_factor(p2, k1, k2) * p2
    return jnp.where(valid, proj, jnp.zeros_like(proj)), valid
