"""Batched block products over the observation axis.

Two forms of each contraction, chosen by problem size (``SMALL_N``):

(a) batched einsums over the (N, 9, 3) / (N, 2, 9) / (N, 2, 3) blocks;
(b) 2-D elementwise multiplies on the flat (N, 27)/(N, 18)/(N, 6) arrays
    followed by matmuls against tiny CONSTANT 0/1 reduction matrices
    ((27, 9) etc.).

Form (b) was written for a tiled device layout that padded the small
block dims of form (a); the switch point was chosen before the H100
port and is not measured on the H100 (ROADMAP D2).

Every product runs at ``Precision.HIGHEST``: these are the CG matvec,
the reduced right-hand side and the Hessian blocks, and TF32 (the card's
default for f32 products, ~1e-3 relative) would put its rounding into
every Schur product and stall CG far above its tolerance. With a 0/1
reduction matrix, HIGHEST makes form (b) an exact f32 group-sum. A
low-precision (bf16/f16) W promotes to f32 before the product, so it
accumulates in f32 as well.

Flat-index conventions (row-major):
    W  (N, 9, 3) -> (N, 27), j = 3 a + b
    Jc (N, 2, 9) -> (N, 18), j = 9 i + a
    Jp (N, 2, 3) -> (N, 6),  j = 3 i + b
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _group_sum(cols: int, groups: int, by_quotient: bool) -> np.ndarray:
    """0/1 matrix (cols, groups): column j contributes to group j//(cols
    //groups) (quotient) or j % groups (remainder)."""
    m = np.zeros((cols, groups), np.float32)
    for j in range(cols):
        g = j // (cols // groups) if by_quotient else j % groups
        m[j, g] = 1.0
    return m


# reduction matrices (constants; dtype adapted at use)
_B27_A = _group_sum(27, 9, by_quotient=True)    # sum over b -> index a
_B27_B = _group_sum(27, 3, by_quotient=False)   # sum over a -> index b
_B18_I = _group_sum(18, 2, by_quotient=True)    # sum over a -> index i
_B18_A = _group_sum(18, 9, by_quotient=False)   # sum over i -> index a
_B6_I = _group_sum(6, 2, by_quotient=True)      # sum over b -> index i
_B6_B = _group_sum(6, 3, by_quotient=False)     # sum over i -> index b


def _mm(prod: jnp.ndarray, B: np.ndarray) -> jnp.ndarray:
    return jnp.dot(prod, jnp.asarray(B, prod.dtype),
                   precision=jax.lax.Precision.HIGHEST)


# Below this many observations the einsum form (a) runs, above it the
# elementwise + constant-matmul form (b). Static per compilation (shapes
# are static). Chosen before the H100 port; not measured on the H100.
SMALL_N = 1 << 18


# --- symmetric 3x3 point-block products --------------------------------------

_B9_A = _group_sum(9, 3, by_quotient=True)      # sum over b -> index a


def m33_dot(M9: jnp.ndarray, t_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("pab,pb->pa", M, t)`` for flat (P, 9) 3x3 blocks
    (row-major j = 3a + b), P-wide along points."""
    n = M9.size // 9
    if n <= SMALL_N:
        return _einsum("pab,pb->pa", M9.reshape(-1, 3, 3), t_rows)
    M9 = M9.reshape(-1, 9)
    return _mm(M9 * jnp.tile(t_rows, (1, 3)), _B9_A)


# --- W (N,27) block products ------------------------------------------------

def w_dot_b(W_f: jnp.ndarray, t_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kab,kb->ka", W, t)``: (N,27) x (N,3) -> (N,9)."""
    n = W_f.size // 27
    if n <= SMALL_N:
        return _einsum("kab,kb->ka", W_f.reshape(-1, 9, 3), t_rows)
    W27 = W_f.reshape(-1, 27)
    return _mm(W27 * jnp.tile(t_rows, (1, 9)), _B27_A)


def wT_dot_a(W_f: jnp.ndarray, v_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kab,ka->kb", W, v)``: (N,27) x (N,9) -> (N,3)."""
    n = W_f.size // 27
    if n <= SMALL_N:
        return _einsum("kab,ka->kb", W_f.reshape(-1, 9, 3), v_rows)
    W27 = W_f.reshape(-1, 27)
    return _mm(W27 * jnp.repeat(v_rows, 3, axis=1), _B27_B)


# --- Jacobian block products -------------------------------------------------

def jc_dot(Jc_f: jnp.ndarray, dc_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kia,ka->ki", Jc, dc)``: (N,18) x (N,9) -> (N,2)."""
    n = Jc_f.size // 18
    if n <= SMALL_N:
        return _einsum("kia,ka->ki", Jc_f.reshape(-1, 2, 9), dc_rows)
    Jc18 = Jc_f.reshape(-1, 18)
    return _mm(Jc18 * jnp.tile(dc_rows, (1, 2)), _B18_I)


def jcT_dot(Jc_f: jnp.ndarray, r_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kia,ki->ka", Jc, r)``: (N,18) x (N,2) -> (N,9)."""
    n = Jc_f.size // 18
    if n <= SMALL_N:
        return _einsum("kia,ki->ka", Jc_f.reshape(-1, 2, 9), r_rows)
    Jc18 = Jc_f.reshape(-1, 18)
    return _mm(Jc18 * jnp.repeat(r_rows, 9, axis=1), _B18_A)


def jp_dot(Jp_f: jnp.ndarray, dp_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kib,kb->ki", Jp, dp)``: (N,6) x (N,3) -> (N,2)."""
    n = Jp_f.size // 6
    if n <= SMALL_N:
        return _einsum("kib,kb->ki", Jp_f.reshape(-1, 2, 3), dp_rows)
    Jp6 = Jp_f.reshape(-1, 6)
    return _mm(Jp6 * jnp.tile(dp_rows, (1, 2)), _B6_I)


def jpT_dot(Jp_f: jnp.ndarray, r_rows: jnp.ndarray) -> jnp.ndarray:
    """``einsum("kib,ki->kb", Jp, r)``: (N,6) x (N,2) -> (N,3)."""
    n = Jp_f.size // 6
    if n <= SMALL_N:
        return _einsum("kib,ki->kb", Jp_f.reshape(-1, 2, 3), r_rows)
    Jp6 = Jp_f.reshape(-1, 6)
    return _mm(Jp6 * jnp.repeat(r_rows, 3, axis=1), _B6_B)


# --- outer products (feed segment reductions) -------------------------------

def jjT_outer(Ja_f: jnp.ndarray, da: int, Jb_f: jnp.ndarray,
              db: int) -> jnp.ndarray:
    """``einsum("kia,kib->kab", Ja, Jb)`` flattened to (N, da*db).

    Ja (N, 2, da), Jb (N, 2, db): sum over the residual index i of the
    per-observation outer products — expressed as two elementwise
    repeat x tile multiplies (no batched dot_general).
    """
    n = Ja_f.size // (2 * da)
    if n <= SMALL_N:
        out = _einsum("kia,kib->kab", Ja_f.reshape(-1, 2, da),
                         Jb_f.reshape(-1, 2, db))
        return out.reshape(-1, da * db)
    Ja2 = Ja_f.reshape(-1, 2 * da)
    Jb2 = Jb_f.reshape(-1, 2 * db)
    out = None
    for i in range(2):
        a = Ja2[:, i * da:(i + 1) * da]
        b = Jb2[:, i * db:(i + 1) * db]
        term = jnp.repeat(a, db, axis=1) * jnp.tile(b, (1, da))
        out = term if out is None else out + term
    return out
