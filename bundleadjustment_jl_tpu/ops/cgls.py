"""Damped CGLS on the full (camera + point) variable space.

The heir of the reference's QR branch (`src/qr_aux.jl` — SPQR of
the damped stacked matrix ``[J; sqrt(lambda) I]``, and the Givens-update
experiment `src/lm_givens.jl`): solve

    min_d || [J; sqrt(lambda) I] d + [r; 0] ||

*directly on J* without ever forming J'J — CGLS recurrences square the
conditioning only implicitly (alpha uses ||J p||^2, not p'(J'J)p), which is
the same numerical advantage QR has over normal equations. No Schur
elimination here: the step lives in the full (dc, dp) space, preconditioned
by the damped block-diagonal of J'J (9x9 camera blocks Cholesky, 3x3 point
blocks closed-form) — the role equilibration plays for the reference's QR
(`src/lma_aux.jl:98-136`).

Trade-off vs the Schur+PCG path: cheaper per iteration (2-row residual
algebra instead of 9x3 W blocks), more iterations (no point elimination).
Exposed as ``solver="cgls"`` / ``use_cgls=True`` in the LM drivers.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops.blockmul import (
    jc_dot, jcT_dot, jp_dot, jpT_dot)
from bundleadjustment_jl_tpu.ops.normal import (
    GNBlocks, damp, inv3x3, seg_by_cam, seg_by_pnt)
from bundleadjustment_jl_tpu.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse)


class CGLSResult(NamedTuple):
    dc: jnp.ndarray
    dp: jnp.ndarray
    iters: jnp.ndarray
    rel_grad: jnp.ndarray


def j_matvec(problem: BAProblem, blocks: GNBlocks,
             dc: jnp.ndarray, dp: jnp.ndarray) -> jnp.ndarray:
    """``J @ d`` per observation: (nobs_pad, 2)."""
    return (jc_dot(blocks.Jc_f, dc[problem.cam_idx])
            + jp_dot(blocks.Jp_f, dp[problem.pnt_idx]))


def jt_matvec(problem: BAProblem, blocks: GNBlocks,
              s: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``J' @ s`` for s of shape (nobs_pad, 2) -> ((ncams,9), (npnts,3))."""
    vc = seg_by_cam(problem, jcT_dot(blocks.Jc_f, s))
    vp = seg_by_pnt(problem, jpT_dot(blocks.Jp_f, s))
    return vc, vp


@partial(jax.jit, static_argnames=("max_iters",))
def cgls_solve(problem: BAProblem, blocks: GNBlocks, lam,
               rtol, max_iters: int = 200) -> CGLSResult:
    """Solve the damped LM step with preconditioned CGLS.

    Returns the step minimizing ``||J d + r||^2 + lambda ||d||^2`` to
    relative preconditioned-gradient tolerance ``rtol``.
    """
    sqlam = jnp.sqrt(lam)
    Mc_inv = block_jacobi_inverse(damp(blocks.Hcc, lam))
    Pp = inv3x3(damp(blocks.Hpp, lam))

    def precond(vc, vp):
        return (block_jacobi_apply(Mc_inv, vc),
                jnp.einsum("pab,pb->pa", Pp, vp,
                           precision=jax.lax.Precision.HIGHEST))

    def dot(ac, ap, bc, bp):
        return jnp.sum(ac * bc) + jnp.sum(ap * bp)

    # x0 = 0; s1 = b = -r ; s2 = -sqrt(lam) x = 0
    # All N-major carries travel FLAT (see GNBlocks).
    s1 = -blocks.r
    vc, vp = jt_matvec(problem, blocks, s1)
    zc, zp = precond(vc, vp)
    gamma0 = dot(vc, vp, zc, zp)
    gamma0_safe = jnp.where(gamma0 <= 0.0, 1.0, gamma0)

    zeros_c = jnp.zeros_like(vc).reshape(-1)
    zeros_p = jnp.zeros_like(vp).reshape(-1)
    state0 = dict(xc=zeros_c, xp=zeros_p, s1=s1.reshape(-1),
                  s2c=zeros_c, s2p=zeros_p,
                  pc=zc.reshape(-1), pp=zp.reshape(-1), gamma=gamma0,
                  it=jnp.asarray(0, jnp.int32))

    def cond(st):
        return jnp.logical_and(st["it"] < max_iters,
                               st["gamma"] > rtol * rtol * gamma0_safe)

    def body(st):
        pc = st["pc"].reshape(-1, 9)
        pp = st["pp"].reshape(-1, 3)
        q1 = j_matvec(problem, blocks, pc, pp)
        denom = (jnp.sum(q1 * q1)
                 + lam * (jnp.sum(pc ** 2) + jnp.sum(pp ** 2)))
        alpha = jnp.where(denom > 0.0, st["gamma"] / denom, 0.0)
        xc = st["xc"] + alpha * st["pc"]
        xp = st["xp"] + alpha * st["pp"]
        s1 = st["s1"] - alpha * q1.reshape(-1)
        s2c = st["s2c"] - alpha * sqlam * st["pc"]
        s2p = st["s2p"] - alpha * sqlam * st["pp"]
        vc, vp = jt_matvec(problem, blocks, s1.reshape(-1, 2))
        vc = vc.reshape(-1) + sqlam * s2c
        vp = vp.reshape(-1) + sqlam * s2p
        zc, zp = precond(vc.reshape(-1, 9), vp.reshape(-1, 3))
        gamma_new = dot(vc, vp, zc.reshape(-1), zp.reshape(-1))
        beta = jnp.where(st["gamma"] > 0.0, gamma_new / st["gamma"], 0.0)
        return dict(xc=xc, xp=xp, s1=s1, s2c=s2c, s2p=s2p,
                    pc=zc.reshape(-1) + beta * st["pc"],
                    pp=zp.reshape(-1) + beta * st["pp"],
                    gamma=gamma_new, it=st["it"] + 1)

    st = jax.lax.while_loop(cond, body, state0)
    rel = jnp.sqrt(jnp.maximum(st["gamma"], 0.0) / gamma0_safe)
    return CGLSResult(dc=st["xc"].reshape(-1, 9),
                      dp=st["xp"].reshape(-1, 3), iters=st["it"],
                      rel_grad=rel)
