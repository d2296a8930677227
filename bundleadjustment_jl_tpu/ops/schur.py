"""Schur-complement elimination of the 3D points.

Replaces the reference's general sparse factorizations — SPQR of
``[J; sqrt(lambda) I]`` (`/root/reference/src/qr_aux.jl`) and LDL^T of the
augmented SQD system (`src/ldl_aux.jl`) — with the structural ordering BA
actually has: points eliminated first. Eliminating the 3x3 point blocks of
the damped normal equations

    [[Hcc_l, W], [W', Hpp_l]] [dc; dp] = -[g_c; g_p]      (Hxx_l = Hxx + lambda I)

gives the *reduced camera system*

    S dc = b,  S = Hcc_l - W Hpp_l^{-1} W',  b = -g_c + W Hpp_l^{-1} g_p
    dp = -Hpp_l^{-1} (g_p + W' dc)

``S`` is never materialized on the large path: `schur_matvec` applies it
matrix-free as two gathers + two batched 9x3 block products + two
segment_sums — O(nobs*54) FLOPs, fully fused by XLA and shardable along the
observation axis (the structure AMD/METIS discover numerically in the
reference, SURVEY.md §2.2, is explicit here). A dense assembly path
(`assemble_dense_schur`) exists for small camera counts and for tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops.blockmul import (
    jc_dot, jp_dot, m33_dot, w_dot_b, wT_dot_a)
from bundleadjustment_jl_tpu.ops import spmdctx
from bundleadjustment_jl_tpu.ops.gatherfree import take_cam, take_pnt
from bundleadjustment_jl_tpu.ops.normal import (
    GNBlocks, damp, inv3x3_damped_flat)
from bundleadjustment_jl_tpu.ops.segsum import (
    segment_sum_scatter, sorted_segment_sum)


class SchurSystem(NamedTuple):
    """The damped, point-eliminated camera system at a given lambda.

    Flat storage + shaped views, like
    :class:`bundleadjustment_jl_tpu.ops.normal.GNBlocks`.
    """
    Hcc_l_f: jnp.ndarray   # flat (ncams*81,) damped camera diagonal blocks
    Hpp_inv_f: jnp.ndarray  # flat (npnts*9,) inverse damped point blocks
    W_f: jnp.ndarray       # flat (nobs_pad*27,)
    b_f: jnp.ndarray       # flat (ncams*9,) reduced RHS
    g_p_f: jnp.ndarray     # flat (npnts*3,) point gradient (back-subst.)
    cam_idx: jnp.ndarray
    pnt_idx: jnp.ndarray
    # sorted-layout metadata (None -> scatter fallback; see ops/segsum.py)
    pnt_starts: jnp.ndarray | None = None
    cam_perm: jnp.ndarray | None = None
    cam_starts: jnp.ndarray | None = None
    pnt_perm: jnp.ndarray | None = None  # None = rows already point-sorted
    # Low-precision range-equilibration scale (see GNBlocks.w_scale): the
    # stored W holds ``s * W``; ``Hpp_inv_f`` and ``g_p_f`` in THIS
    # struct are hatted (``Hpp_inv / s^2``, ``s * g_p``) so every
    # S-product and the reduced RHS are exact, and the point step emerges
    # as ``dp_hat = dp / s`` — unscaled at the back-substitution exit.
    w_scale: jnp.ndarray | None = None

    @property
    def Hcc_l(self):
        return self.Hcc_l_f.reshape(-1, 9, 9)

    @property
    def Hpp_inv(self):
        return self.Hpp_inv_f.reshape(-1, 3, 3)

    @property
    def W(self):
        return self.W_f.reshape(-1, 9, 3)

    @property
    def b(self):
        return self.b_f.reshape(-1, 9)

    @property
    def g_p(self):
        return self.g_p_f.reshape(-1, 3)


def _seg_pnt(sys: "SchurSystem", values: jnp.ndarray) -> jnp.ndarray:
    from bundleadjustment_jl_tpu.ops import segsum
    if segsum.SORTED_MODE and sys.pnt_starts is not None:
        if sys.pnt_perm is not None:
            values = values[sys.pnt_perm]
        return sorted_segment_sum(values, sys.pnt_starts)
    return segment_sum_scatter(values, sys.pnt_idx, sys.Hpp_inv.shape[0])


def _seg_cam(sys: "SchurSystem", values: jnp.ndarray) -> jnp.ndarray:
    from bundleadjustment_jl_tpu.ops import segsum
    if segsum.SORTED_MODE and sys.cam_perm is not None:
        return sorted_segment_sum(values[sys.cam_perm], sys.cam_starts)
    return segment_sum_scatter(values, sys.cam_idx, sys.Hcc_l.shape[0])


def reduce_system(problem: BAProblem, blocks: GNBlocks, lam) -> SchurSystem:
    """Damp with ``lambda`` and form the reduced camera RHS."""
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f = inv3x3_damped_flat(blocks.Hpp_f, lam)
    g_p_f = blocks.g_p_f
    if blocks.w_scale is not None:
        # hatted point space (stored W = s*W): Hpp_inv/s^2, s*g_p — S and
        # b are exact; dp emerges /s and is unscaled at back-substitution.
        Hpp_inv_f = Hpp_inv_f / jnp.square(blocks.w_scale)
        g_p_f = g_p_f * blocks.w_scale
    sys = SchurSystem(Hcc_l_f=Hcc_l.reshape(-1),
                      Hpp_inv_f=Hpp_inv_f,
                      W_f=blocks.W_f,
                      b_f=blocks.g_c_f,  # placeholder, replaced below
                      g_p_f=g_p_f, cam_idx=problem.cam_idx,
                      pnt_idx=problem.pnt_idx,
                      pnt_starts=problem.pnt_starts,
                      cam_perm=problem.cam_perm,
                      cam_starts=problem.cam_starts,
                      pnt_perm=problem.pnt_perm,
                      w_scale=blocks.w_scale)
    # b = -g_c + W Hpp_inv g_p   (one 9x3 block product per observation)
    tmp = m33_dot(sys.Hpp_inv_f, sys.g_p)                    # (npnts,3)
    tmp_obs = take_pnt(tmp, problem.pnt_idx, problem.pnt_starts,
                       problem.pnt_perm)
    # spmd: per-device partial camera sums all-reduce (no-op otherwise)
    corr = spmdctx.psum(_seg_cam(sys, w_dot_b(blocks.W_f, tmp_obs)))
    return sys._replace(b_f=(-blocks.g_c + corr).reshape(-1))


def schur_matvec(sys: SchurSystem, v: jnp.ndarray) -> jnp.ndarray:
    """Matrix-free ``S @ v`` for ``v`` of shape (ncams, 9)."""
    u = jnp.einsum("cab,cb->ca", sys.Hcc_l, v,
                   precision=jax.lax.Precision.HIGHEST)
    # W' v, accumulated per point (point rows are shard-local under spmd)
    t = _seg_pnt(sys, wT_dot_a(sys.W_f, take_cam(v, sys.cam_idx)))
    t = m33_dot(sys.Hpp_inv_f, t)
    t_obs = take_pnt(t, sys.pnt_idx, sys.pnt_starts, sys.pnt_perm)
    u2 = spmdctx.psum(_seg_cam(sys, w_dot_b(sys.W_f, t_obs)))
    return u - u2


def schur_diag_blocks(sys: SchurSystem,
                      chunk: int | str | None = "auto") -> jnp.ndarray:
    """Exact diagonal 9x9 blocks of S (for the block-Jacobi preconditioner).

    ``S_ii = Hcc_l[i] - sum_{k: cam(k)=i} W_k Hpp_inv[pnt(k)] W_k'`` — exact
    because each (cam, pnt) pair appears in one observation, so off-diagonal
    point couplings never land on the diagonal. The per-observation
    ``W C^-1 W'`` product materializes 81 floats/obs, so large problems
    stream it chunked (cf. `ops/normal.py:auto_chunk`).
    """
    from bundleadjustment_jl_tpu.ops.normal import auto_chunk
    ncams = sys.Hcc_l.shape[0]
    n = sys.W_f.size // 27
    if chunk == "auto":
        chunk = auto_chunk(n)
    Hpp_inv9 = sys.Hpp_inv_f.reshape(-1, 9)
    if chunk is None or n <= chunk:
        Hpp_inv_obs = take_pnt(Hpp_inv9, sys.pnt_idx, sys.pnt_starts,
                               sys.pnt_perm).reshape(-1, 3, 3)
        WCW = jnp.einsum("kab,kbc,kdc->kad", sys.W, Hpp_inv_obs, sys.W,
                         precision=jax.lax.Precision.HIGHEST)
        return sys.Hcc_l - spmdctx.psum(_seg_cam(sys, WCW))

    nchunks = n // chunk      # remainder handled as one tail block
    nfull = nchunks * chunk
    rem = n - nfull

    def wcw_sum(W_f, ci, pi, m):
        # The barrier keeps XLA from hoisting the per-chunk (m, 9, 3)
        # reshape out of the scan as one full-width (n, 9, 3) buffer.
        # Chosen before the H100 port; not measured on the H100
        # (ROADMAP D2).
        W_f = jax.lax.optimization_barrier(W_f)
        W = W_f.reshape(m, 9, 3)
        C = Hpp_inv9[pi].reshape(m, 3, 3)
        WCW = jnp.einsum("kab,kbc,kdc->kad", W, C, W,
                         precision=jax.lax.Precision.HIGHEST)
        return segment_sum_scatter(WCW, ci, ncams)

    xs = (sys.W_f[:nfull * 27].reshape(nchunks, chunk * 27),
          sys.cam_idx[:nfull].reshape(nchunks, chunk),
          sys.pnt_idx[:nfull].reshape(nchunks, chunk))

    def body(acc, x):
        W_f, ci, pi = x
        return acc + wcw_sum(W_f, ci, pi, chunk), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros_like(sys.Hcc_l), xs)
    if rem:
        acc = acc + wcw_sum(sys.W_f[nfull * 27:], sys.cam_idx[nfull:],
                            sys.pnt_idx[nfull:], rem)
    return sys.Hcc_l - spmdctx.psum(acc)


def back_substitute(sys: SchurSystem, dc: jnp.ndarray) -> jnp.ndarray:
    """Recover the point step: ``dp = -Hpp_inv (g_p + W' dc)``.

    With a low-precision ``w_scale`` the hatted operands yield
    ``dp_hat = dp / s``; the exit multiplies the scale back."""
    t = _seg_pnt(sys, wT_dot_a(sys.W_f, take_cam(dc, sys.cam_idx)))
    dp = -m33_dot(sys.Hpp_inv_f, sys.g_p + t)
    return dp if sys.w_scale is None else dp * sys.w_scale.astype(dc.dtype)


def quad_form(problem: BAProblem, blocks: GNBlocks,
              dc: jnp.ndarray, dp: jnp.ndarray) -> jnp.ndarray:
    """``||J d||^2 = d' (J'J) d`` from the assembled blocks — no Jc/Jp needed.

    Expansion over the block structure:
    ``dc' Hcc dc + 2 sum_k dc[cam_k]' W_k dp[pnt_k] + dp' Hpp dp``.
    Mathematically >= 0; lets the solver drop the (nobs, 24) Jacobian
    arrays entirely (`assemble_blocks(with_jr=False)`).
    """
    t_c = jnp.sum(dc * jnp.einsum("cab,cb->ca", blocks.Hcc, dc,
                                  precision=jax.lax.Precision.HIGHEST))
    # spmd: Hcc is replicated (t_c redundantly identical per device);
    # Hpp/W are local -> the point and cross terms all-reduce.
    t_p = spmdctx.psum(jnp.sum(dp * m33_dot(blocks.Hpp_f, dp)))
    # stored W is s*W under low-precision range scaling: the cross term
    # (linear in W) consumes dp/s so s cancels exactly (power of two).
    dp_h = dp if blocks.w_scale is None \
        else dp / blocks.w_scale.astype(dp.dtype)
    dp_obs = take_pnt(dp_h, problem.pnt_idx, problem.pnt_starts,
                      problem.pnt_perm)
    cross = spmdctx.psum(jnp.sum(w_dot_b(blocks.W_f, dp_obs)
                                 * take_cam(dc, problem.cam_idx)))
    return t_c + 2.0 * cross + t_p


def predicted_reduction(problem: BAProblem, blocks: GNBlocks,
                        dc: jnp.ndarray, dp: jnp.ndarray) -> jnp.ndarray:
    """Gauss-Newton predicted decrease ``obj - 0.5 ||J d + r||^2``.

    Computed exactly from the block Jacobians:
    ``pred = -(g' d) - 0.5 ||J d||^2`` with
    ``J d`` evaluated per observation as ``Jc dc[cam] + Jp dp[pnt]``
    (the reference reads this off the LDL solution block, `src/lm.jl:227-229`).
    """
    gd = jnp.sum(blocks.g_c * dc) + jnp.sum(blocks.g_p * dp)
    Jd = (jc_dot(blocks.Jc_f, dc[problem.cam_idx])
          + jp_dot(blocks.Jp_f, dp[problem.pnt_idx]))
    return -gd - 0.5 * jnp.sum(Jd * Jd)


# ---------------------------------------------------------------------------
# Dense path (small ncams; tests and direct solves)
# ---------------------------------------------------------------------------

# Dense-path residency cap: the two (3*npnts, 9*ncams) streaming targets
# plus S and temps must fit device memory with headroom.  Past it the
# dense solver is a CAPABILITY gap (like the reference's QR dying at
# scale, `/root/reference/benchmark/first/lmqramd.log`) and is refused
# cleanly BEFORE any compile, instead of failing with a compile-time OOM.
import os as _os
DENSE_MAX_BYTES = int(_os.environ.get("BA_DENSE_MAX_BYTES", 6 << 30))
DENSE_CHUNK = int(_os.environ.get("BA_DENSE_CHUNK", 4096))


def dense_schur_bytes(ncams: int, npnts: int) -> int:
    """Estimated peak device-memory residency of :func:`assemble_dense_schur`."""
    mats = 2 * (3 * npnts) * (9 * ncams) * 4          # U2 / Yd2
    s = 2 * (9 * ncams) ** 2 * 4                      # S + factor
    upd = 2 * 3 * DENSE_CHUNK * 9 * ncams * 4         # chunk updates
    return mats + s + upd


def check_dense_feasible(ncams: int, npnts: int) -> None:
    b = dense_schur_bytes(ncams, npnts)
    if b > DENSE_MAX_BYTES:
        raise MemoryError(
            f"dense Schur gated: ~{b / 2**30:.1f} GB residency at "
            f"ncams={ncams} npnts={npnts} exceeds BA_DENSE_MAX_BYTES="
            f"{DENSE_MAX_BYTES / 2**30:.1f} GB (capability bound, like "
            f"the reference's QR at scale)")


def assemble_dense_schur(sys: SchurSystem) -> jnp.ndarray:
    """Materialize S as a dense (9*ncams, 9*ncams) matrix.

    Streams the per-observation blocks in fixed-size chunks into two
    dense (3*npnts, 9*ncams) matrices — ``U2`` holds the W blocks, and
    ``Yd2`` the ``Y_k = W_k Hpp_inv[pnt(k)]`` blocks — via flat ROW
    scatter-adds (rows 3*pnt+b; the camera placement is a one-hot
    einsum), then contracts them in one big matmul.  A 4-D multi-index
    scatter (`.at[cam_idx, :, pnt_idx, :]`) would lower to a
    f32[9, 3, ncams*npnts] broadcast.  Peak residency is
    O(27 * ncams * npnts) f32 for the two streaming targets only
    (:func:`dense_schur_bytes`); intended for small/medium problems
    where a direct Cholesky beats PCG, and as the oracle for the
    matrix-free path.
    """
    ncams = sys.Hcc_l.shape[0]
    npnts = sys.Hpp_inv.shape[0]
    n = sys.cam_idx.shape[0]
    cdt = (jnp.float32 if sys.W.dtype in (jnp.bfloat16, jnp.float16)
           else sys.W.dtype)
    W = sys.W.astype(cdt)
    Y = jnp.einsum("kab,kbc->kac", W,
                   sys.Hpp_inv[sys.pnt_idx].astype(cdt),
                   precision=jax.lax.Precision.HIGHEST)
    q = min(DENSE_CHUNK, n)
    nfull = (n // q) * q

    def place(blocks, cam):
        # (q, 9, 3) blocks -> (q*3, 9*ncams) rows (k, b) with the 9
        # columns at camera offset 9*cam_k (one-hot contraction).
        oh = (cam[:, None] == jnp.arange(ncams)[None, :]).astype(cdt)
        upd = jnp.einsum("kab,kc->kbca", blocks, oh,
                         precision=jax.lax.Precision.HIGHEST)
        return upd.reshape(q * 3, ncams * 9)

    def step(i, carry):
        U2, Yd2 = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * q, q, 0)
        pnt = sl(sys.pnt_idx)
        rows = (3 * pnt[:, None]
                + jnp.arange(3)[None, :]).reshape(-1)     # (q*3,)
        U2 = U2.at[rows].add(place(sl(W), sl(sys.cam_idx)))
        Yd2 = Yd2.at[rows].add(place(sl(Y), sl(sys.cam_idx)))
        return U2, Yd2

    U2 = jnp.zeros((3 * npnts, 9 * ncams), cdt)
    Yd2 = jnp.zeros((3 * npnts, 9 * ncams), cdt)
    U2, Yd2 = jax.lax.fori_loop(0, n // q, step, (U2, Yd2))
    if n > nfull:
        pnt = sys.pnt_idx[nfull:]
        rows = (3 * pnt[:, None] + jnp.arange(3)[None, :]).reshape(-1)
        oh = (sys.cam_idx[nfull:, None]
              == jnp.arange(ncams)[None, :]).astype(cdt)
        for tgt, blocks in ((0, W[nfull:]), (1, Y[nfull:])):
            upd = jnp.einsum("kab,kc->kbca", blocks, oh,
                             precision=jax.lax.Precision.HIGHEST)
            upd = upd.reshape(-1, ncams * 9)
            if tgt == 0:
                U2 = U2.at[rows].add(upd)
            else:
                Yd2 = Yd2.at[rows].add(upd)
    # S = Hcc_l (block diagonal) - Yd2' U2   (one matmul)
    S = -jax.lax.dot_general(
        Yd2, U2, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)              # (9c, 9c)
    S = S.reshape(ncams, 9, ncams, 9)
    S = S.at[jnp.arange(ncams), :, jnp.arange(ncams), :].add(
        sys.Hcc_l.astype(cdt))
    return S.reshape(9 * ncams, 9 * ncams).astype(sys.W.dtype)


def solve_dense(sys: SchurSystem) -> jnp.ndarray:
    """Direct Cholesky solve of the dense reduced system (small ncams).

    Half precisions factor in f32 (no half-precision Cholesky kernels
    exist in LAPACK or cuSOLVER).
    """
    # Shapes are static, so this raises at TRACE time — every dense
    # entry point (CLI --solver dense, host driver, benchmark runner)
    # gets the clean capability error instead of a compile-time OOM.
    check_dense_feasible(sys.Hcc_l.shape[0], sys.Hpp_inv.shape[0])
    S = assemble_dense_schur(sys)
    dt = S.dtype
    fdt = jnp.float32 if dt in (jnp.bfloat16, jnp.float16) else dt
    dc = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S.astype(fdt), lower=True),
        sys.b.reshape(-1).astype(fdt))
    return dc.reshape(sys.b.shape).astype(dt)
