"""Block-Jacobi preconditioned conjugate gradient on the reduced camera system.

The iterative heir of the reference's direct solves (`src/ldl_aux.jl`
LDL^T / `src/qr_aux.jl` SPQR): instead of refactorizing a sparse matrix each
LM iteration (the reference's dominant cost, SURVEY.md §4.1 "HOT LOOP 3"),
each LM step runs a bounded `lax.while_loop` of matrix-free Schur matvecs —
every iteration is batched einsums + segment_sums that XLA fuses and shards.

Preconditioner: exact block-Jacobi of S (9x9 camera blocks, Cholesky-
factored once per LM step). This is the role the reference's equilibration
(`src/lma_aux.jl:98-166`, `normalize_*`) and fill-reducing orderings play:
taming per-camera scale disparity (focal ~400 vs k2 ~1e-13).

The CG tolerance follows an Eisenstat-Walker-style forcing sequence when
requested, matching inexact-Newton practice; the reference always solves
exactly (direct factorization), which PCG reproduces with ``rtol ~ 1e-12``.
"""

from __future__ import annotations

import os as _os
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# Default window (consecutive CG steps without a 4% best-residual
# improvement) that `lm_jit` passes to `pcg` when W is stored in a low
# precision — the only regime where the matvec is inexact enough that
# the attainable floor can sit above tol. Env-overridable for sweeps.
STAGNATION_WINDOW = int(_os.environ.get("BA_CG_STAG_WINDOW", 8))


class PCGResult(NamedTuple):
    x: jnp.ndarray          # (ncams, 9) solution
    iters: jnp.ndarray      # scalar int32, matvecs used
    rel_res: jnp.ndarray    # scalar, final ||Sx-b|| / ||b||


def _factor_dtype(dtype):
    """Half precisions factor in f32 (neither LAPACK nor cuSOLVER has
    half-precision Cholesky kernels)."""
    if dtype in (jnp.bfloat16, jnp.float16):
        return jnp.float32
    return dtype


def block_cholesky(blocks: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky of SPD preconditioner blocks (ncams, 9, 9).

    Half-precision inputs are factored in f32 (factors stay f32 — the
    preconditioner apply is where the accuracy matters).
    """
    return jnp.linalg.cholesky(blocks.astype(_factor_dtype(blocks.dtype)))


def block_cho_solve(L: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply M^{-1} via the batched Cholesky factors: v is (ncams, 9)."""
    y = jax.scipy.linalg.solve_triangular(
        L, v.astype(L.dtype)[..., None], lower=True)
    z = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)
    return z[..., 0].astype(v.dtype)


def block_jacobi_inverse(blocks: jnp.ndarray) -> jnp.ndarray:
    """Explicit batched M^{-1} of the SPD preconditioner blocks.

    The PCG apply runs EVERY CG iteration; inverting once per lambda
    (two triangular solves against I) turns every apply into one batched
    9x9 matvec instead of two batched triangular solves. The damped
    blocks are SPD with lambda >= 1e-8, so the explicit inverse is as
    stable as the factor-solve here."""
    fdt = _factor_dtype(blocks.dtype)
    L = jnp.linalg.cholesky(blocks.astype(fdt))
    # eye must carry the batch dim explicitly: a (9, 9) rhs is ambiguous
    # to solve_triangular's batching rules
    eye = jnp.broadcast_to(jnp.eye(blocks.shape[-1], dtype=fdt), L.shape)
    y = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.einsum("cka,ckb->cab", y, y,
                      precision=jax.lax.Precision.HIGHEST)


def block_jacobi_apply(Minv: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``M^{-1} v`` from :func:`block_jacobi_inverse` factors."""
    return jnp.einsum("cab,cb->ca", Minv, v.astype(Minv.dtype),
                      precision=jax.lax.Precision.HIGHEST).astype(v.dtype)


@partial(jax.jit, static_argnames=("matvec", "precond", "max_iters",
                                   "stagnation_window"))
def pcg(matvec: Callable, b: jnp.ndarray, precond: Callable,
        rtol, max_iters: int = 100, x0=None,
        stagnation_window: int = 0) -> PCGResult:
    """Preconditioned CG for ``S x = b`` with S SPD, matrix-free.

    ``b``/``x`` have shape (ncams, 9); inner products run over all entries.
    Stops when ``||r|| <= rtol * ||b||`` or after ``max_iters`` matvecs
    (static bound — the whole loop stays on device inside one XLA while).

    ``stagnation_window > 0`` additionally stops after that many
    consecutive steps without a 4% best-residual improvement — for
    INEXACT matvecs (low-precision W storage) whose attainable residual
    floor can sit just above ``tol``.  Off by default: exact-arithmetic
    CG may legitimately plateau for long stretches on ill-conditioned S
    before superlinear convergence kicks in (the rtol=1e-12
    direct-solve parity test stalls at 1.7e-6 with a window of 8).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)

    def dot(u, v):
        return jnp.sum(u * v)

    bnorm = jnp.sqrt(dot(b, b))
    # Guard: a zero RHS means the zero step is exact.
    bnorm_safe = jnp.where(bnorm == 0.0, 1.0, bnorm)
    tol = rtol * bnorm_safe

    r0 = b - matvec(x0)
    z0 = precond(r0)
    state0 = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0, jnp.int32),
              jnp.asarray(False), dot(r0, r0), jnp.asarray(0, jnp.int32))

    def cond(state):
        x, r, z, p, rz, it, down, best_r2, stag = state
        live = jnp.logical_and(
            jnp.logical_and(it < max_iters, jnp.logical_not(down)),
            jnp.sqrt(dot(r, r)) > tol)
        if stagnation_window > 0:
            live = jnp.logical_and(live, stag < stagnation_window)
        return live

    def body(state):
        x, r, z, p, rz, it, _, best_r2, stag = state
        Sp = matvec(p)
        pSp = dot(p, Sp)
        # Breakdown (pSp <= 0: S numerically indefinite — e.g. the
        # low-precision-W perturbed Schur complement at small lambda) is
        # a STOP, not a guard: with alpha forced to 0 the recurrence
        # spins unchanged until max_iters (measured: 278 vs 69 total
        # matvecs at Dubrovnik-356 with bf16 W). Returning the current
        # iterate is standard CG practice; LM's gain-ratio acceptance
        # handles the inexact step.
        down = pSp <= 0.0
        alpha = jnp.where(down, 0.0, rz / jnp.where(down, 1.0, pSp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        # Stagnation: with an inexact matvec (low-precision W) the
        # attainable residual stalls at ~eps_facto * kappa-ish, which can
        # sit just ABOVE tol — CG then grinds to max_iters chasing matvec
        # noise (27-30 matvecs/solve at LadyBug-460 with bf16 W). Track
        # the best ||r||^2; no 4%
        # improvement in `stagnation_window` consecutive steps = converged
        # to the attainable floor, stop. LM's gain-ratio acceptance
        # absorbs the resulting inexact step.
        r2 = dot(r, r)
        improved = r2 < 0.96 * best_r2
        stag = jnp.where(improved, 0, stag + 1).astype(jnp.int32)
        best_r2 = jnp.minimum(best_r2, r2)
        return (x, r, z, p, rz_new, it + 1, down, best_r2, stag)

    x, r, _, _, _, it, _, _, _ = jax.lax.while_loop(cond, body, state0)
    return PCGResult(x=x, iters=it,
                     rel_res=jnp.sqrt(dot(r, r)) / bnorm_safe)


@partial(jax.jit, static_argnames=("matvec", "m_apply", "m_solve",
                                   "max_terms"))
def power_series(matvec: Callable, b: jnp.ndarray, m_apply: Callable,
                 m_solve: Callable, rtol, max_terms: int = 50) -> PCGResult:
    """Power-series (preconditioned Richardson) solve of ``S x = b``.

    With the splitting ``S = M - N`` (M = the damped block-diagonal camera
    part, N = the Schur coupling term), iterate the Neumann expansion

        x_{k+1} = M^{-1} (b + N x_k),   N x = M x - S x

    the scheme popularized for BA by "Power Bundle Adjustment for
    Large-Scale 3D Reconstruction" (arXiv:2204.12834): convergence is
    guaranteed for the damped Schur complement (both M and N are PSD), each
    term costs exactly one S-matvec, and unlike CG the recurrence has no
    inner products — attractive when global reductions are the bottleneck
    on a large mesh.

    ``m_apply(x) = M x`` and ``m_solve(y) = M^{-1} y``.
    """
    bnorm = jnp.sqrt(jnp.sum(b * b))
    bnorm_safe = jnp.where(bnorm == 0.0, 1.0, bnorm)
    x0 = m_solve(b)

    def cond(state):
        x, res, it = state
        return jnp.logical_and(it < max_terms, res > rtol * bnorm_safe)

    def body(state):
        x, _, it = state
        Sx = matvec(x)
        res = jnp.sqrt(jnp.sum((b - Sx) ** 2))
        x = m_solve(b + m_apply(x) - Sx)
        return (x, res, it + 1)

    x, res, it = jax.lax.while_loop(
        cond, body, (x0, jnp.asarray(jnp.inf, b.dtype),
                     jnp.asarray(0, jnp.int32)))
    return PCGResult(x=x, iters=it, rel_res=res / bnorm_safe)


def forcing_rtol(grad_norm: jnp.ndarray, floor=1e-10, cap=1e-2):
    """Eisenstat-Walker-style forcing term: tighter as the gradient shrinks.

    eta = clip(sqrt(||g||), floor, cap) relative tolerance; keeps early LM
    iterations cheap while recovering near-direct accuracy at convergence.
    """
    return jnp.clip(jnp.sqrt(grad_norm), floor, cap)
