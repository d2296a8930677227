"""Fully-jitted Levenberg-Marquardt: the whole solve as ONE compiled XLA
program (`lax.while_loop`), zero host round-trips.

Same algorithm as :func:`bundleadjustment_jl_tpu.solver.lm.levenberg_marquardt`
(the reference's `src/lm.jl` semantics — lambda schedule, gain-ratio
acceptance, stopping tests) but with all control flow as traced `lax.cond`/
`where` on device. This is the benchmark configuration: the reference pays
Julia<->C FFI and host orchestration every iteration; here the only host
interaction is the final result fetch.

Two drivers share one compiled iteration body:

- :func:`levenberg_marquardt_jit` — the full solve in a single
  `lax.while_loop` (one init dispatch + one loop dispatch).
- :func:`levenberg_marquardt_jit_chunked` — the same loop segmented into
  host-checked chunks of K iterations, which restores the two reference
  capabilities a single compiled loop cannot express: the ``max_time``
  wall-clock stop (`/root/reference/src/lm.jl:26,118`, the ``tired`` test)
  and true checkpoint/resume (SURVEY.md §6) for Final-scale runs.

Differences from the host-stepped driver (both documented):
- linesearch evaluates all candidate scales in one batched pass when
  enabled (the reference halves sequentially, `lm.jl:263-295`).
- history is recorded into fixed (max_iters,) device arrays.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops.blockmul import jc_dot, jp_dot
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks, gradient_norm
from bundleadjustment_jl_tpu.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse, forcing_rtol, pcg)
from bundleadjustment_jl_tpu.ops import spmdctx
from bundleadjustment_jl_tpu.ops.residuals import residuals
from bundleadjustment_jl_tpu.ops.schur import (
    back_substitute, quad_form, reduce_system, schur_diag_blocks,
    schur_matvec, solve_dense)

# Status codes (mapping of the reference's statuses, `lm.jl:391-405`)
RUNNING = 0
FIRST_ORDER = 1
SMALL_RESIDUAL = 2
SMALL_STEP = 3
SMALL_OBJ_CHANGE = 4
MAX_ITER = 5
EXCEPTION = 6
MAX_TIME = 7

# Above this many bytes of batched (S, nobs, 9) trial-scale camera gather,
# the linesearch objectives are evaluated serially (lax.map) instead of
# vmapped. The limit sits far below device memory because a tiled device
# layout once padded that gather many times over. Chosen before the H100
# port; not measured on the H100 (ROADMAP D2).
TRIAL_VMAP_MAX_BYTES = 1 << 26

STATUS_NAMES = {
    FIRST_ORDER: "first_order",
    SMALL_RESIDUAL: "small_residual",
    SMALL_STEP: "small_step",
    SMALL_OBJ_CHANGE: "small_obj_change",
    MAX_ITER: "max_iter",
    EXCEPTION: "exception",
    MAX_TIME: "max_time",
    RUNNING: "running",
}

# Static configuration shared by the jitted init/segment kernels.
# ``gather_mode`` mirrors ops.gatherfree.MODE purely to key the jit cache —
# the ops read the global at trace time, so a mode flip must retrace.
# ``obs_sharded``: the observation arrays are split over several devices
# (GSPMD layout, `parallel/mesh.py`); see :func:`_obs_sharded`.
_STATIC = ("max_iters", "pcg_max_iters", "use_dense", "use_cgls",
           "use_power", "linesearch", "ls_max", "lam0_mode",
           "use_forcing", "facto_dtype", "pcg_warm", "gather_mode",
           "sorted_mode", "obs_sharded")


def _obs_sharded(problem: BAProblem) -> bool:
    """True when ``problem``'s observation arrays are split over more than
    one device (GSPMD, `parallel/mesh.py:shard_problem`).

    The streamed (`lax.scan`) forms of the assembly, the Schur diagonal
    and the objective walk the observation axis chunk by chunk; on an
    axis the partitioner has split, every step's chunk lives on one
    device, so it all-gathers each chunk (and W) to every device and
    each device runs the whole assembly. Sharded problems therefore take
    the whole-width forms, which partition row-wise with only
    all-reduces of the camera- and point-space sums; each device's
    temporaries scale with its own rows.
    """
    sh = getattr(problem.cam_idx, "sharding", None)
    return (isinstance(sh, jax.sharding.Sharding)
            and len(sh.device_set) > 1 and not sh.is_fully_replicated)


def _chunk(obs_sharded: bool):
    """``chunk`` argument of the streamed ops (see :func:`_obs_sharded`)."""
    return None if obs_sharded else "auto"


class LMJitResult(NamedTuple):
    cams: jnp.ndarray
    points: jnp.ndarray
    objective: jnp.ndarray      # scalar
    dual_feas: jnp.ndarray      # scalar ||J'r||
    iterations: jnp.ndarray     # scalar int32
    status: jnp.ndarray         # scalar int32, see STATUS_NAMES
    # per-iteration traces, fixed length max_iters (valid up to `iterations`)
    hist_obj: jnp.ndarray
    hist_gnorm: jnp.ndarray
    hist_lam: jnp.ndarray
    hist_cg: jnp.ndarray
    # Evaluation counters (the reference's neval_cons/neval_jac bookkeeping,
    # `BALNLPModels.jl:116,126,162`): exact int32 carried in the while-loop.
    naccepts: jnp.ndarray = None
    elapsed_time: float = float("nan")  # wall seconds (chunked driver only)

    def status_name(self) -> str:
        return STATUS_NAMES[int(self.status)]

    @property
    def neval_jac(self) -> int:
        # one linearization per accepted step + the initial one
        return int(self.naccepts) + 1

    @property
    def neval_residual(self) -> int:
        # one trial objective per iteration (n_scales with linesearch is
        # still one batched evaluation) + the linearization residuals
        return int(self.iterations) + self.neval_jac


# CG relative-tolerance floor under low-precision W storage, as a multiple
# of eps(facto_dtype).  The bf16-perturbed S supports descent directions,
# not tight linear solves: driving CG below ~8*eps(facto) chases matvec
# noise (longer solves) AND yields steps the f32 objective rejects near
# convergence (LM rejection churn).  Swept 0.5/4/8 over the LadyBug ->
# Venice ladder + Trafalgar-257 (iteration and matvec counts): at 8,
# bf16-W matches f32 LM iterations within +1 everywhere while using
# ~0.5x the CG matvecs; at 0.5 Trafalgar took ~3.6x the matvecs.
# LM absorbs the looser step via its gain-ratio test (inexact-Newton,
# forcing eta <= 0.5 preserves local convergence).  Env-overridable.
import os as _os
_CG_FLOOR_MULT = float(_os.environ.get("BA_CG_FLOOR_MULT", 8.0))


def _objective(problem, cams, points, obs_sharded=False):
    # sum-of-squares, not vdot: under vmap (batched trial scales) vdot
    # becomes a batched dot_general at default precision (TF32 on the
    # card).
    from bundleadjustment_jl_tpu.ops.residuals import (
        GATHER_CHUNK, GATHER_DIRECT_MAX_BYTES, objective_chunked)
    itemsize = jnp.dtype(cams.dtype).itemsize
    if (not obs_sharded
            and problem.nobs_pad * 9 * itemsize > GATHER_DIRECT_MAX_BYTES):
        return spmdctx.psum(objective_chunked(
            problem, cams, points, GATHER_CHUNK))
    r = residuals(problem, cams, points)
    # spmd: rows are device-local -> the sum all-reduces (no-op otherwise)
    return spmdctx.psum(0.5 * jnp.sum(r * r))


def _resolve_hp(dtype, atol, rtol, restol, satol, srtol, oatol, ortol,
                nu_d, nu_m, accept_ratio, good_ratio, lam_min, pcg_rtol,
                lam_strategy="ref"):
    """Traced hyperparameter dict; ``None`` tolerances resolve to the
    reference defaults in the working dtype (`lm.jl:21-24`)."""
    eps = jnp.finfo(dtype).eps
    cbrt = eps ** (1.0 / 3.0)
    sqrt_ = jnp.sqrt(eps)
    pick = lambda v, d: jnp.asarray(d if v is None else v, dtype)  # noqa
    return dict(
        atol=pick(atol, sqrt_), rtol=pick(rtol, cbrt),
        restol=pick(restol, cbrt), satol=pick(satol, sqrt_),
        srtol=pick(srtol, sqrt_), oatol=pick(oatol, sqrt_),
        ortol=pick(ortol, cbrt), nu_d=pick(nu_d, 3.0),
        nu_m=pick(nu_m, 3.0), accept_ratio=pick(accept_ratio, 1e-4),
        good_ratio=pick(good_ratio, 0.9), lam_min=pick(lam_min, 1e-8),
        pcg_rtol=pick(pcg_rtol, 0.0),
        nielsen=pick(1.0 if lam_strategy == "nielsen" else 0.0, 0.0),
    )


def _w_assemble_dtype(facto_dtype):
    """Dtype the assembly may write W in directly: f16 must NOT be
    written raw (range overflow before the equilibration scale is known —
    see :func:`_maybe_cast_facto`); bf16 shares f32's exponent range and
    is safe to emit straight from the assembly."""
    if facto_dtype is None or jnp.dtype(facto_dtype) == jnp.float16:
        return None
    return facto_dtype


def _maybe_cast_facto(blocks, facto_dtype):
    """Low-precision storage of the factorization operands — the heir of
    the reference's ``facto_type`` mixed precision (`lm.jl:99`
    passing the type into `ldl_analyse`; low-type L storage
    `ldl_aux.jl:272-282`). The outer LM (residuals, gradients, acceptance,
    tolerances) stays in the working dtype; only the bulk per-observation
    ``W`` blocks (27 floats/obs — the dominant device-memory traffic of
    the PCG matvec) are stored in ``facto_dtype``. The small diagonal
    blocks (``Hcc``: 81/camera, ``Hpp``: 9/point) stay full-precision:
    casting them too inflated LM iterations ~4x in the counts taken when
    this was written, wiping out the byte saving. Products promote W to
    f32 and accumulate in f32.

    float16 additionally range-equilibrates — the heir of the reference's
    ``normalize_F16!`` global range scale (`lma_aux.jl:27-52`, wired at
    `lm.jl:165-169`): BAL focals put raw ``|W| ~ f^2`` far above f16's
    65504 max, so a raw cast silently infs. The stored W is ``s * W``
    with ``s`` an exact power of two placing the max entry at ~2^14;
    consumers hat ``Hpp_inv`` by ``1/s^2`` / ``g_p`` by ``s`` and unscale
    ``dp`` at the exits (`ops/schur.py`) — the same damped system, only
    f16 rounding differs."""
    if facto_dtype is None:
        return blocks
    fd = jnp.dtype(facto_dtype)
    scale = None
    if fd == jnp.float16:
        wmax = spmdctx.pmax(jnp.max(jnp.abs(blocks.W_f))
                            .astype(jnp.float32))
        safe = jnp.where(jnp.isfinite(wmax) & (wmax > 0), wmax, 1.0)
        scale = jnp.exp2(jnp.floor(jnp.log2(16384.0 / safe)))
    mul = 1.0 if scale is None else scale
    if scale is None and blocks.W_f.dtype == fd:
        # Already emitted in the storage dtype by the assembly
        # (`_w_assemble_dtype`): skip a redundant *1.0 copy of W.
        return blocks
    return blocks._replace(W_f=(blocks.W_f * mul).astype(fd),
                           w_scale=scale)


def _lm_init_impl(problem: BAProblem, cams, points, hp, *, max_iters,
             pcg_max_iters, use_dense, use_cgls, use_power, linesearch,
             ls_max, lam0_mode, use_forcing, facto_dtype,
             pcg_warm, gather_mode, sorted_mode, obs_sharded):
    """Initial linearization + solver state (one compiled dispatch)."""
    del pcg_max_iters, use_power, linesearch, ls_max, use_dense
    del use_forcing, pcg_warm, gather_mode, sorted_mode
    dtype = cams.dtype
    blocks0 = assemble_blocks(
        problem, cams, points, chunk=_chunk(obs_sharded), with_jr=use_cgls,
        w_dtype=_w_assemble_dtype(facto_dtype))
    obj0 = blocks0.obj
    gnorm0 = gradient_norm(blocks0)
    blocks0 = _maybe_cast_facto(blocks0, facto_dtype)

    if lam0_mode == "diag":
        # Madsen-Nielsen-style: lambda_0 = tau * max diag(J'J) — scale-aware,
        # unlike the reference's 1e10/||J'r|| which assumes BAL-sized
        # gradient norms (`lm.jl:59`).
        # strided column slices of the flat views
        maxdiag = jnp.maximum(
            jnp.max(blocks0.Hcc_f.reshape(-1, 81)[:, ::10]),
            spmdctx.pmax(
                jnp.max(blocks0.Hpp_f.reshape(-1, 9)[:, ::4]))).astype(dtype)
        lam_init = 1e-3 * maxdiag
    else:
        lam_init = jnp.maximum(
            30.0, 1e10 / jnp.maximum(gnorm0, 1e-300)).astype(dtype)

    zeros_h = jnp.zeros((max_iters,), dtype)
    zeros_i = jnp.zeros((max_iters,), jnp.int32)
    # cams/points travel FLAT in the carry (see GNBlocks).
    return dict(
        cams=cams.reshape(-1), points=points.reshape(-1),
        blocks=blocks0, obj=obj0, gnorm=gnorm0,
        lam=lam_init, it=jnp.asarray(0, jnp.int32),
        it_max=jnp.asarray(max_iters, jnp.int32),
        gtol=hp["atol"] + hp["rtol"] * gnorm0,   # fixed at entry
        #                                          (`lm.jl:111-114`)
        nrejects=jnp.asarray(0, jnp.int32),
        naccepts=jnp.asarray(0, jnp.int32),
        dc=jnp.zeros((cams.shape[0] * 9,), dtype),  # PCG warm-start carry
        nu=jnp.asarray(2.0, dtype),
        status=jnp.asarray(RUNNING, jnp.int32),
        hist_obj=zeros_h, hist_gnorm=zeros_h, hist_lam=zeros_h,
        hist_cg=zeros_i,
    )


_lm_init = partial(jax.jit, static_argnames=_STATIC)(_lm_init_impl)


def _lm_run_impl(problem: BAProblem, state, hp, *, max_iters, pcg_max_iters,
            use_dense, use_cgls, use_power, linesearch, ls_max, lam0_mode,
            use_forcing, facto_dtype, pcg_warm, gather_mode, sorted_mode,
            obs_sharded):
    """Run LM iterations until ``status != RUNNING`` or ``it == it_max``."""
    del lam0_mode, gather_mode, sorted_mode
    dtype = state["cams"].dtype
    # "Narrow" = the matvec/objective resolution is coarser than f32:
    # either the facto storage dtype is narrower than the working width,
    # or the WORKING dtype itself is half-precision (cascade low
    # stages). The CG floor / stagnation window / pred-reduction stop
    # only make sense then; an explicit facto_dtype=float32 is an exact
    # matvec and keeps the reference stopping semantics (advisor, round
    # 4: gating on `is not None` truncated legitimate CG plateaus in
    # the rtol=1e-12 parity configuration). The half-working case is
    # load-bearing for the bf16 cascade stage: near its floor the
    # OBJECTIVE quantizes (ulp(2e4) ~ 78 in bf16) so ared rounds to 0,
    # every step rejects, and without the pred-reduction stop the stage
    # burns rejections into a NaN instead of stopping at the floor.
    facto_narrow = ((facto_dtype is not None
                     and jnp.dtype(facto_dtype).itemsize < 4)
                    or jnp.dtype(dtype).itemsize < 4)

    def linearize(c, p):
        # Hot path keeps only the reduced blocks (with_jr=False): obj is
        # folded into assembly and ||J d||^2 comes from quad_form, so the
        # (nobs, 26) r/Jc/Jp arrays never hit HBM. CGLS iterates on J
        # directly and is the one solver that still needs them.
        # w_dtype: the streamed assembly casts each W chunk in-body so
        # the full-width f32 W never exists (f16 returns None here and
        # casts after the range scale is known).
        blocks = assemble_blocks(
            problem, c, p, chunk=_chunk(obs_sharded), with_jr=use_cgls,
            w_dtype=_w_assemble_dtype(facto_dtype))
        return (_maybe_cast_facto(blocks, facto_dtype), blocks.obj,
                gradient_norm(blocks))

    # scales tried per iteration: [1] or [1, 1/2, ..., 1/2^ls_max]
    scales = jnp.asarray(
        [1.0] + ([0.5 ** j for j in range(1, ls_max + 1)]
                 if linesearch else []), dtype)

    def cond(st):
        return jnp.logical_and(st["it"] < st["it_max"],
                               st["status"] == RUNNING)

    def body(st):
        blocks, lam = st["blocks"], st["lam"]
        cams = st["cams"].reshape(-1, 9)
        points = st["points"].reshape(-1, 3)
        obj, gnorm = st["obj"], st["gnorm"]

        rtol_cg = (forcing_rtol(gnorm) if use_forcing
                   else hp["pcg_rtol"]).astype(dtype)
        if facto_narrow:
            # Low-precision W bounds the achievable matvec accuracy: CG
            # cannot converge below ~eps(facto) relative residual and
            # stagnates there burning matvecs (about 4x the f32 matvec
            # count at Dubrovnik-356 with bf16 W before this floor). LM
            # absorbs the inexact step via its gain-ratio acceptance
            # (inexact-Newton).
            narrow_dt = (jnp.dtype(facto_dtype)
                         if facto_dtype is not None else jnp.dtype(dtype))
            floor = _CG_FLOOR_MULT * float(jnp.finfo(narrow_dt).eps)
            rtol_cg = jnp.maximum(rtol_cg, jnp.asarray(floor, dtype))
        lam_f = lam
        if use_cgls:
            from bundleadjustment_jl_tpu.ops.cgls import cgls_solve
            cres = cgls_solve(problem, blocks, lam, rtol=rtol_cg,
                              max_iters=pcg_max_iters)
            dc, dp, cg_iters = cres.dc, cres.dp, cres.iters
        elif use_power:
            from bundleadjustment_jl_tpu.ops.pcg import power_series
            sys = reduce_system(problem, blocks, lam_f)
            M_inv = block_jacobi_inverse(sys.Hcc_l)
            pres = power_series(
                lambda v: schur_matvec(sys, v), sys.b,
                lambda v: jnp.einsum("cab,cb->ca", sys.Hcc_l, v,
                                     precision=jax.lax.Precision.HIGHEST),
                lambda v: block_jacobi_apply(M_inv, v),
                rtol=rtol_cg, max_terms=pcg_max_iters)
            dc, cg_iters = pres.x, pres.iters
        elif use_dense:
            sys = reduce_system(problem, blocks, lam_f)
            dc = solve_dense(sys)
            cg_iters = jnp.asarray(0, jnp.int32)
        else:
            sys = reduce_system(problem, blocks, lam_f)
            M_inv = block_jacobi_inverse(
                schur_diag_blocks(sys, chunk=_chunk(obs_sharded)))
            # Warm start from the previous LM iteration's camera step (the
            # reduced system changes only through lambda and the accepted
            # re-linearization) — saves CG matvecs late in the solve.
            x0 = st["dc"].reshape(-1, 9).astype(sys.b.dtype) \
                if pcg_warm else None
            # Stagnation stop only with an inexact (low-precision-W)
            # matvec — exact CG may plateau legitimately; see ops/pcg.py.
            from bundleadjustment_jl_tpu.ops.pcg import STAGNATION_WINDOW
            stag = STAGNATION_WINDOW if facto_narrow else 0
            res = pcg(lambda v: schur_matvec(sys, v), sys.b,
                      lambda v: block_jacobi_apply(M_inv, v),
                      rtol=rtol_cg, max_iters=pcg_max_iters, x0=x0,
                      stagnation_window=stag)
            dc, cg_iters = res.x, res.iters
        if not use_cgls:
            dp = back_substitute(sys, dc)
            Jd2_nc = quad_form(problem, blocks, dc, dp)
        dc = dc.astype(dtype)
        dp = dp.astype(dtype)

        # spmd: g_c/dc replicated, g_p/dp local per shard
        gd = (jnp.sum(blocks.g_c * dc)
              + spmdctx.psum(jnp.sum(blocks.g_p * dp)))
        if use_cgls:
            Jd = (jc_dot(blocks.Jc_f, dc[problem.cam_idx])
                  + jp_dot(blocks.Jp_f, dp[problem.pnt_idx]))
            Jd2 = jnp.sum(Jd * Jd)
        else:
            Jd2 = Jd2_nc.astype(dtype)
        dnorm = jnp.sqrt(jnp.sum(dc * dc)
                         + spmdctx.psum(jnp.sum(dp * dp)))
        xnorm = jnp.sqrt(jnp.sum(cams ** 2)
                         + spmdctx.psum(jnp.sum(points ** 2)))

        # A NaN step (f32 Cholesky of a near-indefinite system at small
        # lambda) is treated as a REJECTION — lambda grows and the solve
        # retries — rather than the reference's immediate ``fail2``
        # termination (`lm.jl:297-302`). Only a NaN at an already-huge
        # lambda is hopeless and terminates.
        nan_step = jnp.logical_not(jnp.isfinite(dnorm))
        fatal_nan = jnp.logical_and(nan_step, lam > 1e20)
        small_step = jnp.logical_and(jnp.logical_not(nan_step),
                                     dnorm < hp["satol"]
                                     + hp["srtol"] * xnorm)

        # Evaluate all trial scales in one pass; pick the first acceptable
        # (scale 1.0 first, so plain LM when linesearch=False).
        def trial_obj(s):
            return _objective(problem, cams + s * dc, points + s * dp,
                              obs_sharded)

        # vmapping S trial scales materializes an (S, nobs, 9) camera
        # gather in one fusion; serialize the scales with lax.map once
        # that would exceed TRIAL_VMAP_MAX_BYTES (one evaluation per LM
        # iteration, S <= 5, so the linesearch is off the hot path).
        batched_gather_bytes = int(scales.shape[0]) * problem.nobs_pad * 9 * 4
        if batched_gather_bytes > TRIAL_VMAP_MAX_BYTES:
            objs_t = jax.lax.map(trial_obj, scales)
        else:
            objs_t = jax.vmap(trial_obj)(scales)
        preds = -scales * gd - 0.5 * scales * scales * Jd2
        areds = obj - objs_t
        ok = jnp.logical_and(
            jnp.logical_and(preds > 0, areds >= hp["accept_ratio"] * preds),
            jnp.isfinite(objs_t))
        any_ok = jnp.any(ok)
        first = jnp.argmax(ok)          # index of first True
        s_sel = scales[first]
        obj_t = objs_t[first]
        pred = preds[first]
        ared = areds[first]
        del obj_t

        accept = jnp.logical_and(any_ok,
                                 jnp.logical_not(nan_step))
        cams_t = cams + s_sel * dc
        points_t = points + s_sel * dp

        # lambda update: reference schedule (`lm.jl:306-337`) or Nielsen.
        # Both are computed and selected by the TRACED hp["nielsen"] flag —
        # a handful of scalar ops buys one fewer XLA program per config.
        nrej_new = jnp.where(accept, 0, st["nrejects"] + 1).astype(jnp.int32)
        nielsen = hp["nielsen"] > 0
        rho = jnp.where(pred > 0, ared / pred, -jnp.inf)
        nl_acc = jnp.maximum(
            lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            hp["lam_min"])
        nl_rej = lam * st["nu"]
        ref_acc = jnp.maximum(
            lam / hp["nu_d"]
            / jnp.where(ared >= hp["good_ratio"] * pred, hp["nu_d"], 1.0),
            hp["lam_min"])
        dnorm_safe = jnp.where(jnp.isfinite(dnorm), dnorm, jnp.inf)
        # Reference reject rule `lm.jl:306-308`:
        # lambda = max(lambda, 1/||delta||) * nu_m^(ntimes+1) with
        # ntimes = linesearch halvings this iteration (0 without
        # linesearch -> one factor nu_m per reject, NOT cumulative).
        n_halvings = ls_max if linesearch else 0
        ref_rej = (jnp.maximum(lam, 1.0 / jnp.maximum(dnorm_safe, 1e-300))
                   * hp["nu_m"] ** (n_halvings + 1))
        lam_acc = jnp.where(nielsen, nl_acc, ref_acc)
        lam_rej = jnp.where(nielsen, nl_rej, ref_rej)
        nu_new = jnp.where(
            nielsen,
            jnp.where(accept, 2.0, st["nu"] * 2.0), st["nu"]).astype(dtype)
        lam_new = jnp.where(accept, lam_acc, lam_rej)

        # Re-linearize only on accept.
        def on_accept(_):
            b, o, g = linearize(cams_t, points_t)
            return cams_t.reshape(-1), points_t.reshape(-1), b, o, g

        def on_reject(_):
            return cams.reshape(-1), points.reshape(-1), blocks, obj, gnorm

        cams_n, points_n, blocks_n, obj_n, gnorm_n = jax.lax.cond(
            accept, on_accept, on_reject, None)

        obj_tol = hp["oatol"] + hp["ortol"] * jnp.abs(obj)
        small_obj = jnp.logical_and(accept, obj - obj_n < obj_tol)
        if facto_narrow:
            # Predicted-reduction stop (low-precision-W path only): when
            # even the Gauss-Newton model's full predicted decrease is
            # below the small-obj-change tolerance, any accepted step
            # would stop next iteration — and a REJECTED one (common at
            # the noise floor with low-precision W: the perturbed step's
            # ared goes negative while pred stays tiny) would burn
            # further solves at growing lambda for progress the tolerance
            # already deems negligible. Mirrors the actual-decrease test
            # one step early (`lm.jl`'s small_obj ared test; same
            # tolerance). Full-precision runs keep the reference-exact
            # stopping semantics (host/jit driver parity tests pin them).
            # Guarded by the first-order criterion (within 3 orders of
            # gtol): after a run of REJECTIONS inflates lambda, the
            # damped model's pred ~ ||g||^2/lambda can fall below
            # obj_tol while the gradient is still large — that is
            # lambda growth, not convergence (advisor, round 4).
            small_obj = jnp.logical_or(
                small_obj,
                jnp.logical_and(
                    jnp.logical_and(pred > 0, pred < obj_tol),
                    st["gnorm"] < 1e3 * st["gtol"]))

        rnorm_n = jnp.sqrt(2.0 * obj_n)
        status = jnp.where(
            fatal_nan, EXCEPTION,
            jnp.where(small_step, SMALL_STEP,
                      jnp.where(gnorm_n < st["gtol"], FIRST_ORDER,
                                jnp.where(rnorm_n < hp["restol"],
                                          SMALL_RESIDUAL,
                                          jnp.where(small_obj,
                                                    SMALL_OBJ_CHANGE,
                                                    RUNNING))))
        ).astype(jnp.int32)

        it = st["it"]
        return dict(
            cams=cams_n, points=points_n, blocks=blocks_n, obj=obj_n,
            gnorm=gnorm_n, lam=lam_new, it=it + 1, it_max=st["it_max"],
            gtol=st["gtol"], nrejects=nrej_new,
            # never carry a NaN step into the next warm start
            dc=jnp.where(jnp.isfinite(dnorm), dc.reshape(-1), 0.0),
            naccepts=st["naccepts"] + accept.astype(jnp.int32),
            nu=nu_new, status=status,
            hist_obj=st["hist_obj"].at[it].set(obj),
            hist_gnorm=st["hist_gnorm"].at[it].set(gnorm),
            hist_lam=st["hist_lam"].at[it].set(lam),
            hist_cg=st["hist_cg"].at[it].set(cg_iters),
        )

    del max_iters
    return jax.lax.while_loop(cond, body, state)


# ``state`` is DONATED: without donation the full solver state (including
# the (nobs*27,) W blocks) stays pinned as an input while the while-loop
# double-buffers its carry — a ~2x peak-memory tax. Callers never reuse
# the state they pass in.
# The `_impl` (unjitted) forms exist for `solver/lm_spmd.py`, which traces
# them inside one shard_map.
_lm_run = partial(jax.jit, static_argnames=_STATIC,
                  donate_argnums=(1,))(_lm_run_impl)


def _finalize(st, final_status=None, elapsed=float("nan")) -> LMJitResult:
    status = int(st["status"])
    if status == RUNNING:
        status = MAX_ITER if final_status is None else final_status
    return LMJitResult(
        cams=st["cams"].reshape(-1, 9), points=st["points"].reshape(-1, 3),
        objective=st["obj"],
        dual_feas=st["gnorm"], iterations=st["it"],
        status=jnp.asarray(status, jnp.int32),
        hist_obj=st["hist_obj"], hist_gnorm=st["hist_gnorm"],
        hist_lam=st["hist_lam"], hist_cg=st["hist_cg"],
        naccepts=st["naccepts"], elapsed_time=elapsed)


def _split_options(problem, cams, points, max_iters, lam0, lam0_mode,
                   atol, rtol, restol, satol, srtol, oatol, ortol,
                   nu_d, nu_m, accept_ratio, good_ratio, lam_min,
                   lam_strategy, pcg_rtol, pcg_max_iters, use_dense,
                   use_cgls, use_power, linesearch, ls_max, facto_dtype,
                   pcg_warm):
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    hp = _resolve_hp(cams.dtype, atol, rtol, restol, satol, srtol, oatol,
                     ortol, nu_d, nu_m, accept_ratio, good_ratio, lam_min,
                     pcg_rtol, lam_strategy)
    static = dict(max_iters=max_iters, pcg_max_iters=pcg_max_iters,
                  use_dense=use_dense, use_cgls=use_cgls,
                  use_power=use_power, linesearch=linesearch, ls_max=ls_max,
                  lam0_mode=lam0_mode,
                  use_forcing=pcg_rtol is None,
                  facto_dtype=(None if facto_dtype is None
                               else jnp.dtype(facto_dtype).name),
                  pcg_warm=pcg_warm)
    # Trace-time global flags mirrored into the static key so flag flips
    # retrace (the ops read the globals during tracing).
    from bundleadjustment_jl_tpu.ops import gatherfree, segsum
    static["gather_mode"] = gatherfree.MODE
    static["sorted_mode"] = segsum.SORTED_MODE
    static["obs_sharded"] = _obs_sharded(problem)
    return cams, points, hp, static


def _split_kw(problem, cams, points, max_iters, options):
    """``(lam0, _split_options(...))`` from keyword ``options`` — those of
    :func:`levenberg_marquardt_jit`."""
    o = dict(options)
    lam0 = o.pop("lam0", None)
    split = _split_options(
        problem, cams, points, max_iters,
        lam0, o.pop("lam0_mode", "ref"),
        o.pop("atol", None), o.pop("rtol", None),
        o.pop("restol", None), o.pop("satol", None),
        o.pop("srtol", None), o.pop("oatol", None),
        o.pop("ortol", None), o.pop("nu_d", 3.0),
        o.pop("nu_m", 3.0), o.pop("accept_ratio", 1e-4),
        o.pop("good_ratio", 0.9), o.pop("lam_min", 1e-8),
        o.pop("lam_strategy", "ref"), o.pop("pcg_rtol", None),
        o.pop("pcg_max_iters", 100), o.pop("use_dense", False),
        o.pop("use_cgls", False), o.pop("use_power", False),
        o.pop("linesearch", False), o.pop("ls_max", 4),
        o.pop("facto_dtype", None), o.pop("pcg_warm", False))
    if o:
        raise TypeError(f"unknown options: {sorted(o)}")
    return lam0, split


def compile_lm(problem: BAProblem, cams=None, points=None, *,
               max_iters: int = 200, **options):
    """Compile the two programs of :func:`levenberg_marquardt_jit` (the
    initial linearization and the LM loop) for this problem's shapes and
    these options, without running them. Returns ``(init, run)``
    compiled executables, e.g. for ``memory_analysis()``; with the
    persistent compile cache on, the solve then loads them instead of
    compiling again."""
    _, (cams, points, hp, static) = _split_kw(
        problem, cams, points, max_iters, options)
    init = _lm_init.lower(problem, cams, points, hp, **static).compile()
    state = jax.eval_shape(partial(_lm_init, **static),
                           problem, cams, points, hp)
    run = _lm_run.lower(problem, state, hp, **static).compile()
    return init, run


def levenberg_marquardt_jit(
    problem: BAProblem, cams=None, points=None, *,
    max_iters: int = 200,
    lam0=None, lam0_mode: str = "ref",
    atol=None, rtol=None, restol=None, satol=None, srtol=None,
    oatol=None, ortol=None,
    nu_d=3.0, nu_m=3.0, accept_ratio=1e-4, good_ratio=0.9, lam_min=1e-8,
    lam_strategy: str = "ref",
    pcg_rtol=None, pcg_max_iters: int = 100,
    use_dense: bool = False, use_cgls: bool = False,
    use_power: bool = False,
    linesearch: bool = False, ls_max: int = 4,
    facto_dtype=None, pcg_warm: bool = False,
) -> LMJitResult:
    """One-call LM solve; every option is a traced scalar except the static
    structure/iteration-bound flags. ``None`` tolerances resolve to the
    reference defaults in the working dtype (`lm.jl:21-24`).

    ``facto_dtype``: store the per-observation ``W`` and diagonal Hessian
    blocks in this dtype (e.g. ``jnp.bfloat16``) inside a full-precision LM
    loop — the equivalent of the reference's low-precision factorization
    (`lm.jl:99`, `ldl_aux.jl:272-282`); halves the dominant device-memory
    traffic of the PCG matvec at bf16.

    ``pcg_warm``: start each PCG solve from the previous iteration's
    camera step instead of zero (fewer matvecs late in the solve).
    """
    cams, points, hp, static = _split_options(
        problem, cams, points, max_iters, lam0, lam0_mode, atol, rtol,
        restol, satol, srtol, oatol, ortol, nu_d, nu_m, accept_ratio,
        good_ratio, lam_min, lam_strategy, pcg_rtol, pcg_max_iters,
        use_dense, use_cgls, use_power, linesearch, ls_max, facto_dtype,
        pcg_warm)
    state = _lm_init(problem, cams, points, hp, **static)
    if lam0 is not None:
        state = dict(state, lam=jnp.asarray(lam0, cams.dtype))
    return _finalize(_lm_run(problem, state, hp, **static))


def levenberg_marquardt_jit_chunked(
    problem: BAProblem, cams=None, points=None, *,
    max_iters: int = 200,
    chunk_iters: int = 25,
    max_time: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,          # in chunks
    resume: bool = False,
    callback=None,
    stop_after_chunks: Optional[int] = None,
    **options,
) -> LMJitResult:
    """LM solve segmented into host-checked chunks of ``chunk_iters``.

    Same compiled iteration body as :func:`levenberg_marquardt_jit` (the
    segment kernel compiles once and is reused), with host control between
    segments providing:

    - ``max_time``: wall-clock bound, honored within one chunk — the
      reference's ``tired`` test (`lm.jl:26,118`; default there 3600 s).
    - ``checkpoint_dir``: write a ``step-<n>.npz`` checkpoint after every
      ``checkpoint_every`` chunks (cams/points/lambda/iteration + the
      entry-fixed gradient threshold, so a resumed run continues the exact
      stopping test).
    - ``resume=True``: restore the latest checkpoint from
      ``checkpoint_dir`` before solving.
    - ``callback(dict)``: called after each chunk with scalar progress.

    All remaining keyword ``options`` are those of
    :func:`levenberg_marquardt_jit`.
    """
    lam0, (cams, points, hp, static) = _split_kw(
        problem, cams, points, max_iters, options)

    ckpt_mgr = None
    restored = None
    if checkpoint_dir is not None:
        from bundleadjustment_jl_tpu.utils.checkpoint import CheckpointManager
        ckpt_mgr = CheckpointManager(checkpoint_dir, every=1)
        if resume:
            restored = ckpt_mgr.restore_latest()
            if restored is not None:
                cams = jnp.asarray(restored["cams"], cams.dtype)
                points = jnp.asarray(restored["points"], points.dtype)

    t0 = time.perf_counter()
    state = _lm_init(problem, cams, points, hp, **static)
    if restored is not None:
        state = dict(
            state,
            lam=jnp.asarray(restored["lam"], cams.dtype),
            it=jnp.asarray(restored["iteration"], jnp.int32))
        gtol = restored["meta"].get("gtol")
        if gtol is not None:
            state["gtol"] = jnp.asarray(gtol, cams.dtype)
    elif lam0 is not None:
        state = dict(state, lam=jnp.asarray(lam0, cams.dtype))

    final_status = None
    nchunk = 0
    # ONE coalesced fetch of every host-checked scalar per chunk: each
    # separate int()/float() would be its own device->host transfer.
    scal = jax.device_get({k: state[k] for k in
                           ("it", "status", "obj", "gnorm", "lam", "gtol")})
    while True:
        it = int(scal["it"])
        if int(scal["status"]) != RUNNING or it >= max_iters:
            break
        if max_time is not None and time.perf_counter() - t0 > max_time:
            final_status = MAX_TIME
            break
        state = dict(state, it_max=jnp.asarray(
            min(it + chunk_iters, max_iters), jnp.int32))
        state = _lm_run(problem, state, hp, **static)
        nchunk += 1
        scal = jax.device_get({k: state[k] for k in
                               ("it", "status", "obj", "gnorm", "lam",
                                "gtol")})
        if ckpt_mgr is not None and nchunk % max(1, checkpoint_every) == 0:
            ckpt_mgr.maybe_save(
                int(scal["it"]), state["cams"].reshape(-1, 9),
                state["points"].reshape(-1, 3), lam=float(scal["lam"]),
                meta={"objective": float(scal["obj"]),
                      "gtol": float(scal["gtol"]),
                      "problem": problem.name})
        if callback is not None:
            callback({"iter": int(scal["it"]),
                      "obj": float(scal["obj"]),
                      "gnorm": float(scal["gnorm"]),
                      "lam": float(scal["lam"]),
                      "status": STATUS_NAMES[int(scal["status"])],
                      "elapsed": time.perf_counter() - t0})
        if stop_after_chunks is not None and nchunk >= stop_after_chunks:
            # Warm-up hook: benchmarks dispatch one chunk to absorb
            # compilation and executable load before the timed solve —
            # the same role as bench.py's warm-up solve.
            break

    return _finalize(state, final_status=final_status,
                     elapsed=time.perf_counter() - t0)
