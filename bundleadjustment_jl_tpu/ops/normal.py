"""Block assembly of the damped Gauss-Newton (normal-equation) system.

The reference factors the sparse augmented system
``K = [[I J];[J' -lambda I]]`` with a custom LDL^T
(`/root/reference/src/ldl_aux.jl`) or SPQR (`src/qr_aux.jl`), relying on
AMD/METIS orderings to contain fill. This formulation exploits the
*block* structure of bundle adjustment instead (SURVEY.md §2.2): the
Gauss-Newton matrix of ``J = [Jc | Jp]`` is

    H = [[Hcc, Hcp], [Hcp', Hpp]]

where ``Hcc`` is block-diagonal with 9x9 camera blocks, ``Hpp`` is
block-diagonal with 3x3 point blocks, and ``Hcp`` has one 9x3 block ``W_k``
per observation (each (cam, pnt) pair appears in at most one observation in
BAL data). All blocks are assembled as batched einsums + `segment_sum` —
dense, static-shaped, mesh-shardable along the observation axis.

Damping is the reference's Levenberg ``lambda * I`` (the LDL system
``[[I J];[J' -lambda I]]`` is the augmented form of
``(J'J + lambda I) delta = -J'r``, `src/lm.jl:68-81`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops.jacobian import residuals_and_jacobian
from bundleadjustment_jl_tpu.ops.segsum import (
    segment_sum_scatter, sorted_segment_sum)


def seg_by_pnt(problem: BAProblem, values: jnp.ndarray) -> jnp.ndarray:
    """Per-observation values -> per-point sums (scan path only when
    segsum.SORTED_MODE is enabled)."""
    from bundleadjustment_jl_tpu.ops import segsum
    if segsum.SORTED_MODE and problem.pnt_starts is not None:
        if problem.pnt_perm is not None:
            values = values[problem.pnt_perm]
        return sorted_segment_sum(values, problem.pnt_starts)
    return segment_sum_scatter(values, problem.pnt_idx, problem.npnts)


def seg_by_cam(problem: BAProblem, values: jnp.ndarray) -> jnp.ndarray:
    """Per-observation values -> per-camera sums."""
    from bundleadjustment_jl_tpu.ops import segsum
    if segsum.SORTED_MODE and problem.cam_perm is not None:
        return sorted_segment_sum(values[problem.cam_perm],
                                  problem.cam_starts)
    return segment_sum_scatter(values, problem.cam_idx, problem.ncams)


class GNBlocks(NamedTuple):
    """Damped Gauss-Newton system in block form (all batched-dense).

    Storage is FLAT (1-D) per array; the shaped views (``r``, ``Jc``,
    ``Jp``, ``W``, ...) are zero-cost reshapes fused into consumers. The
    flat carries were chosen for a tiled device layout before the H100
    port; not measured on the H100 (ROADMAP D2).

    ``r_f``/``Jc_f``/``Jp_f`` are ``None`` when assembled with
    ``with_jr=False`` (the hot-solver configuration): the LM step needs only
    the reduced quantities — ``obj`` (folded into assembly) and the step
    quadratic form ``||J d||^2`` via :func:`...ops.schur.quad_form` — so the
    (nobs, 26) raw residual/Jacobian arrays are never written to HBM.
    """
    g_c_f: jnp.ndarray   # flat (ncams*9,)    J_c' r
    g_p_f: jnp.ndarray   # flat (npnts*3,)    J_p' r
    Hcc_f: jnp.ndarray   # flat (ncams*81,)   camera diagonal blocks
    Hpp_f: jnp.ndarray   # flat (npnts*9,)    point diagonal blocks
    W_f: jnp.ndarray     # flat (nobs_pad*27,) per-observation Hcp blocks
    obj: jnp.ndarray     # scalar 0.5 ||r||^2 at the linearization point
    r_f: jnp.ndarray | None = None   # flat (nobs_pad*2,) weighted residuals
    Jc_f: jnp.ndarray | None = None  # flat (nobs_pad*18,)
    Jp_f: jnp.ndarray | None = None  # flat (nobs_pad*6,)
    # Range-equilibration scale for low-precision W storage (the heir of
    # the reference's `normalize_F16!` global range scale,
    # `/root/reference/src/lma_aux.jl:27-52` wired at `lm.jl:165-169`):
    # the stored W arrays hold ``s * W`` with ``s`` a power of two chosen
    # so the largest entry fits the storage dtype's range (f16 max
    # 65504; BAL focals ~400-1000 put raw |W| ~ f^2 >> that). Exactness:
    # this is the variable scaling dp = s * dp_hat — the Schur system
    # S, b are invariant (W enters them once with Hpp_inv and once
    # squared with Hpp_inv once), and consumers hat Hpp_inv by 1/s^2,
    # g_p by s, and unscale dp at the exits (`ops/schur.py`). None = 1.
    w_scale: jnp.ndarray | None = None

    @property
    def g_c(self):
        return self.g_c_f.reshape(-1, 9)

    @property
    def g_p(self):
        return self.g_p_f.reshape(-1, 3)

    @property
    def Hcc(self):
        return self.Hcc_f.reshape(-1, 9, 9)

    @property
    def Hpp(self):
        return self.Hpp_f.reshape(-1, 3, 3)

    @property
    def W(self):
        return self.W_f.reshape(-1, 9, 3)

    @property
    def r(self):
        return self.r_f.reshape(-1, 2)

    @property
    def Jc(self):
        return self.Jc_f.reshape(-1, 2, 9)

    @property
    def Jp(self):
        return self.Jp_f.reshape(-1, 2, 3)

    @classmethod
    def from_shaped(cls, g_c, g_p, Hcc, Hpp, W, obj, r=None, Jc=None,
                    Jp=None):
        flat = lambda x: None if x is None else x.reshape(-1)  # noqa: E731
        return cls(g_c.reshape(-1), g_p.reshape(-1), Hcc.reshape(-1),
                   Hpp.reshape(-1), W.reshape(-1), obj, flat(r),
                   flat(Jc), flat(Jp))


# Streaming-chunk rows for lax.scan-based assembly/diag at large nobs.
# Each step materializes ~8 KB/obs of linearization temps, so CHUNK_ROWS
# bounds memory; steps = n/CHUNK_ROWS bounds the loop's serial depth.
# 2^16 = ~21 steps at Dubrovnik-356 with ~0.5 GB of temps per step.
# Chosen before the H100 port; not measured on the H100 (ROADMAP D2).
# Overridable via BA_CHUNK for A/B runs (read at import).
import os as _os
CHUNK_ROWS = int(_os.environ.get("BA_CHUNK", 1 << 16))


def auto_chunk(n: int, threshold: int = 1 << 18) -> int | None:
    """Observation-chunk size for streaming assembly: None for small
    problems (whole-width is fastest), else :data:`CHUNK_ROWS` (the
    remainder is handled by callers as one tail block)."""
    return None if n <= threshold else CHUNK_ROWS


def assemble_blocks(problem: BAProblem, cams=None, points=None,
                    chunk: int | str | None = "auto",
                    with_jr: bool = True,
                    w_dtype=None) -> GNBlocks:
    """Linearize at (cams, points) and assemble all Gauss-Newton blocks.

    One fused pass: residuals, Jacobian blocks, gradients and Hessian blocks.
    Padded observations carry zero Jacobians/residuals so every segment_sum
    is exact. This replaces the reference's sparse-matrix assembly
    (`src/lm.jl:61-81`) and its COO SpMV ``J'r`` (`src/lma_aux.jl:191-212`).

    ``chunk``: stream the observation axis through a `lax.scan` in chunks of
    this size (bounding temp memory); "auto" picks via :func:`auto_chunk`.

    ``with_jr=False`` (hot-solver path): do not keep the per-observation
    ``r``/``Jc``/``Jp`` arrays — the LM iteration only needs the reduced
    blocks, the folded-in ``obj``, and `ops.schur.quad_form` for the step
    quadratic. Saves ~104 B/obs of device-memory writes + the same in
    later reads.

    ``w_dtype``: store W in this dtype (the low-precision facto storage);
    the streamed branch casts each chunk so a full-width W in the working
    dtype never exists.
    """
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    n = problem.nobs_pad
    if chunk == "auto":
        chunk = auto_chunk(n)
    from bundleadjustment_jl_tpu.ops.blockmul import (
        jcT_dot, jjT_outer, jpT_dot)
    from bundleadjustment_jl_tpu.ops import spmdctx
    if chunk is None or n <= chunk:
        r, Jc, Jp = residuals_and_jacobian(problem, cams, points)
        Jc_f, Jp_f = Jc.reshape(-1), Jp.reshape(-1)
        # spmd (`solver/lm_spmd.py`): rows are device-local, so the
        # camera-space outputs (obj, g_c, Hcc) are per-device partials
        # that all-reduce over the mesh axis; point-space outputs
        # (g_p, Hpp, W) stay local (points are shard-owned). No-ops
        # outside a shard_map (spmdctx.AXIS is None).
        obj = spmdctx.psum(0.5 * jnp.sum(r * r))
        g_c = spmdctx.psum(seg_by_cam(problem, jcT_dot(Jc_f, r)))
        g_p = seg_by_pnt(problem, jpT_dot(Jp_f, r))
        Hcc = spmdctx.psum(
            seg_by_cam(problem, jjT_outer(Jc_f, 9, Jc_f, 9))).reshape(
            -1, 9, 9)
        Hpp = seg_by_pnt(problem, jjT_outer(Jp_f, 3, Jp_f, 3)).reshape(
            -1, 3, 3)
        W = jjT_outer(Jc_f, 9, Jp_f, 3)
        if w_dtype is not None:
            W = W.astype(w_dtype)
        if not with_jr:
            r = Jc = Jp = None
        return GNBlocks.from_shaped(g_c, g_p, Hcc, Hpp, W, obj, r, Jc, Jp)

    from bundleadjustment_jl_tpu.ops.jacobian import rj_raw
    from bundleadjustment_jl_tpu.ops.segsum import segment_sum_scatter
    nchunks = n // chunk          # remainder rows handled as one tail block
    nfull = nchunks * chunk
    rem = n - nfull
    nc, np_ = problem.ncams, problem.npnts
    dt = cams.dtype

    def block(ci, pi, xy_f, w, m):
        """One chunk's contributions (m = rows in this block); the
        accumulators stay flat 1-D like the GNBlocks fields."""
        r, Jc, Jp = rj_raw(cams, points, ci, pi, xy_f.reshape(m, 2), w)
        Jc_f, Jp_f = Jc.reshape(-1), Jp.reshape(-1)
        return (0.5 * jnp.sum(r * r),
                segment_sum_scatter(jcT_dot(Jc_f, r), ci, nc).reshape(-1),
                segment_sum_scatter(jpT_dot(Jp_f, r), pi, np_).reshape(-1),
                segment_sum_scatter(jjT_outer(Jc_f, 9, Jc_f, 9), ci,
                                    nc).reshape(-1),
                segment_sum_scatter(jjT_outer(Jp_f, 3, Jp_f, 3), pi,
                                    np_).reshape(-1),
                jjT_outer(Jc_f, 9, Jp_f, 3),
                (r, Jc_f, Jp_f))

    # The per-step arrays travel FLAT (chunk*d,) and are reshaped outside
    # the scan, and each step dynamic-slices its (chunk, 2) pt2d window
    # straight out of the parameter, so no whole-array copy of the (n, 2)
    # input is ever made. Chosen for a tiled device layout before the
    # H100 port; not measured on the H100 (ROADMAP D2).
    xs = (problem.cam_idx[:nfull].reshape(nchunks, chunk),
          problem.pnt_idx[:nfull].reshape(nchunks, chunk),
          jnp.arange(nchunks, dtype=jnp.int32) * chunk,
          problem.w[:nfull].reshape(nchunks, chunk))
    carry0 = (jnp.zeros((nc * 9,), dt), jnp.zeros((np_ * 3,), dt),
              jnp.zeros((nc * 81,), dt), jnp.zeros((np_ * 9,), dt),
              jnp.zeros((), dt))

    # Cast each W chunk to the storage dtype INSIDE the scan (bf16
    # facto): the stacked ys buffer is then (n*27,) in w_dtype and the
    # full-width f32 W (3.4 GB at Final-13682 sizes) never exists. f16
    # cannot take this path (range scale needs the global max first,
    # `_maybe_cast_facto`) — its callers pass w_dtype=None here.
    wd = dt if w_dtype is None else jnp.dtype(w_dtype)

    def body(carry, x):
        g_c, g_p, Hcc, Hpp, obj = carry
        ci, pi, row0, w = x
        xy = jax.lax.dynamic_slice(
            problem.pt2d, (row0, jnp.zeros((), row0.dtype)),
            (chunk, 2))
        dobj, dg_c, dg_p, dHcc, dHpp, W, (r, Jc_f, Jp_f) = block(
            ci, pi, xy.reshape(-1), w, chunk)
        ys = (W.reshape(-1).astype(wd),) if not with_jr else (
            W.reshape(-1).astype(wd), r.reshape(-1), Jc_f, Jp_f)
        return (g_c + dg_c, g_p + dg_p, Hcc + dHcc, Hpp + dHpp,
                obj + dobj), ys

    (g_c, g_p, Hcc, Hpp, obj), ys = jax.lax.scan(body, carry0, xs)
    W = ys[0].reshape(-1)
    r, Jc, Jp = (ys[1], ys[2], ys[3]) if with_jr else (None, None, None)
    flat = lambda x: None if x is None else x.reshape(-1)  # noqa: E731
    r, Jc, Jp = flat(r), flat(Jc), flat(Jp)
    if rem:
        dobj, dg_c, dg_p, dHcc, dHpp, W_t, (r_t, Jc_t, Jp_t) = block(
            problem.cam_idx[nfull:], problem.pnt_idx[nfull:],
            problem.pt2d[nfull:].reshape(-1), problem.w[nfull:], rem)
        obj = obj + dobj
        g_c, g_p = g_c + dg_c, g_p + dg_p
        Hcc, Hpp = Hcc + dHcc, Hpp + dHpp
        W = jnp.concatenate([W, W_t.reshape(-1).astype(wd)])
        if with_jr:
            r = jnp.concatenate([r, r_t.reshape(-1)])
            Jc = jnp.concatenate([Jc, Jc_t])
            Jp = jnp.concatenate([Jp, Jp_t])
    # spmd: one camera-space all-reduce after the streaming accumulation
    # (see the whole-width branch above); point-space stays local.
    return GNBlocks(
        g_c_f=spmdctx.psum(g_c), g_p_f=g_p,
        Hcc_f=spmdctx.psum(Hcc), Hpp_f=Hpp,
        W_f=W, obj=spmdctx.psum(obj), r_f=r, Jc_f=Jc, Jp_f=Jp)


def gradient_norm(blocks: GNBlocks) -> jnp.ndarray:
    """||J'r|| over the full variable vector (`src/lm.jl:57`, dual_feas).

    spmd: ``g_c`` is replicated (psummed at assembly), ``g_p`` is local
    per shard — only the point term all-reduces."""
    from bundleadjustment_jl_tpu.ops import spmdctx
    return jnp.sqrt(jnp.sum(blocks.g_c_f ** 2)
                    + spmdctx.psum(jnp.sum(blocks.g_p_f ** 2)))


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form (adjugate) inverse of 3x3 SPD blocks.

    Cheaper than a general LU and stable for the damped point blocks
    ``Hpp + lambda I`` (lambda >= 1e-8, `src/lm.jl:337`). Half precisions
    compute in f32 and cast back (determinant products underflow in bf16).
    """
    dt = M.dtype
    if dt in (jnp.bfloat16, jnp.float16):
        return inv3x3(M.astype(jnp.float32)).astype(dt)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    # Conditioning guard: real BAL data has near-degenerate points whose
    # damped blocks can reach det <= tiny (underflow) or non-finite entries.
    # Fall back to the diagonal (Jacobi) inverse there — step stays finite
    # and roughly scaled; pathological steps are then handled by the LM
    # reject-and-grow-lambda logic instead of poisoning the whole solve.
    ok = jnp.isfinite(det) & (det > jnp.finfo(dt).tiny * 8.0)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ], axis=-2)
    inv = adj * inv_det[..., None, None]
    diag = jnp.stack([a, e, i], axis=-1)
    dinv = 1.0 / jnp.maximum(jnp.where(jnp.isfinite(diag), diag, 0.0),
                             jnp.finfo(dt).tiny * 8.0)
    fallback = dinv[..., :, None] * jnp.eye(3, dtype=dt)
    return jnp.where(ok[..., None, None], inv, fallback)


def inv3x3_damped_flat(Hpp_f: jnp.ndarray, lam) -> jnp.ndarray:
    """``inv3x3(damp(Hpp, lam))`` computed entirely on flat (P, 9) columns
    (row-major j = 3a + b); column slices of a (P, 9) view stay fused.
    Same conditioning guard as :func:`inv3x3`.

    The direct form keeps about two (P, 9) buffers live (the nine
    adjugate columns and the stacked result); past
    ``residuals.GATHER_DIRECT_MAX_BYTES`` of them the same computation
    streams through a fori_loop in ``GATHER_CHUNK``-point chunks."""
    dt = Hpp_f.dtype
    if dt in (jnp.bfloat16, jnp.float16):
        return inv3x3_damped_flat(Hpp_f.astype(jnp.float32),
                                  lam).astype(dt)
    from bundleadjustment_jl_tpu.ops.residuals import (
        GATHER_CHUNK, GATHER_DIRECT_MAX_BYTES)
    P = Hpp_f.size // 9
    if 2 * P * 9 * jnp.dtype(dt).itemsize > GATHER_DIRECT_MAX_BYTES:
        chunk = min(GATHER_CHUNK, P)
        nchunks = P // chunk
        nfull = nchunks * chunk

        def step(i, out):
            blk = jax.lax.dynamic_slice(
                Hpp_f, (i * (chunk * 9),), (chunk * 9,))
            return jax.lax.dynamic_update_slice(
                out, _inv3x3_damped_flat_direct(blk, lam),
                (i * (chunk * 9),))

        out = jax.lax.fori_loop(
            0, nchunks, step, jnp.zeros((P * 9,), dt))
        if P > nfull:
            out = jax.lax.dynamic_update_slice(
                out, _inv3x3_damped_flat_direct(Hpp_f[nfull * 9:], lam),
                (nfull * 9,))
        return out
    return _inv3x3_damped_flat_direct(Hpp_f, lam)


def _inv3x3_damped_flat_direct(Hpp_f: jnp.ndarray, lam) -> jnp.ndarray:
    dt = Hpp_f.dtype
    M = Hpp_f.reshape(-1, 9)
    lam = jnp.asarray(lam, dt)
    a, b, c = M[:, 0] + lam, M[:, 1], M[:, 2]
    d, e, f = M[:, 3], M[:, 4] + lam, M[:, 5]
    g, h, i = M[:, 6], M[:, 7], M[:, 8] + lam
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    ok = jnp.isfinite(det) & (det > jnp.finfo(dt).tiny * 8.0)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    z = jnp.zeros_like(a)
    da = 1.0 / jnp.maximum(jnp.where(jnp.isfinite(a), a, 0.0),
                           jnp.finfo(dt).tiny * 8.0)
    de = 1.0 / jnp.maximum(jnp.where(jnp.isfinite(e), e, 0.0),
                           jnp.finfo(dt).tiny * 8.0)
    di = 1.0 / jnp.maximum(jnp.where(jnp.isfinite(i), i, 0.0),
                           jnp.finfo(dt).tiny * 8.0)
    cols = [jnp.where(ok, adj * inv_det, fb) for adj, fb in
            zip((A, B, C, D, E, F, G, H, I),
                (da, z, z, z, de, z, z, z, di))]
    return jnp.stack(cols, axis=-1).reshape(-1)


def damp(H: jnp.ndarray, lam) -> jnp.ndarray:
    """Add ``lambda I`` to a batch of square blocks (Levenberg damping)."""
    n = H.shape[-1]
    return H + lam * jnp.eye(n, dtype=H.dtype)
