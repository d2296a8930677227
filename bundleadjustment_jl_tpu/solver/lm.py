"""Levenberg-Marquardt on the Schur-reduced camera system.

Re-architecture of the reference solver
(`/root/reference/src/lm.jl:15-418`, ``Levenberg_Marquardt``). The outer LM
logic keeps the reference's *known-good hyperparameters* (SURVEY.md §8):

- lambda_0 = max(30, 1e10 / ||J'r_0||)                      (`lm.jl:59`)
- accept iff ared >= 1e-4 * pred                            (`lm.jl:251-260`)
- accept: lambda /= 3, extra /3 when ared >= 0.9 * pred,
  floor 1e-8                                                (`lm.jl:329-337`)
- reject: lambda = max(lambda, 1/||delta||) * 3^(halvings+1) (`lm.jl:306-308`,
  ntimes = linesearch halvings this iteration; one factor 3 per reject
  without linesearch)
- optional linesearch: up to 4 step-halvings on reject      (`lm.jl:263-295`)
- stopping: small_step / first_order / small_residual /
  small_obj_change / tired                                  (`lm.jl:111-123`)
- default tolerances in the working dtype's eps             (`lm.jl:21-24`)

What changed is *how a step is computed*: instead of refactorizing a sparse
LDL^T/QR each iteration (the reference's dominant cost), points are
eliminated in closed form (`ops/schur.py`) and the reduced camera system is
solved either by dense Cholesky (small camera counts) or matrix-free
block-Jacobi PCG — every inner op is a batched einsum / segment_sum that XLA
fuses and shards.

Two drivers share all device code:

- :func:`levenberg_marquardt` — host-stepped loop: per-iteration Python
  control, rich logging (the reference's `log_row` of
  iter/f/|J'r|/lambda/|d|/rho, `lm.jl:120-121,304`), callbacks. One or two
  compiled calls per LM iteration; scalars only cross the host boundary.
- :func:`levenberg_marquardt_jit` (in `solver/lm_jit.py`) — the whole solve
  as one `lax.while_loop` under jit: zero host round-trips, the benchmark
  flagship.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks, gradient_norm
from bundleadjustment_jl_tpu.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse, forcing_rtol, pcg)
from bundleadjustment_jl_tpu.ops.residuals import residuals
from bundleadjustment_jl_tpu.ops.schur import (
    back_substitute, reduce_system, schur_diag_blocks, schur_matvec,
    solve_dense)


@dataclasses.dataclass
class LMOptions:
    """Solver options. Defaults mirror `src/lm.jl:15-26` where applicable.

    ``None`` tolerances resolve to the reference's dtype-adaptive defaults
    (`lm.jl:21-24`): restol/ortol/rtol = eps^(1/3), satol/srtol/oatol/atol
    = sqrt(eps) in the working dtype.
    """
    max_iters: int = 200                  # ite_max (`lm.jl:24`)
    max_time: float = 3600.0              # seconds (`lm.jl:26`)
    atol: Optional[float] = None          # first-order absolute
    rtol: Optional[float] = None          # first-order relative
    restol: Optional[float] = None        # small residual
    satol: Optional[float] = None         # small step absolute
    srtol: Optional[float] = None         # small step relative
    oatol: Optional[float] = None         # small obj change absolute
    ortol: Optional[float] = None         # small obj change relative
    lam0: Optional[float] = None          # None -> lam0_mode heuristic
    lam0_mode: str = "ref"                # "ref": max(30, 1e10/|J'r0|)
    #                                       (`lm.jl:59`); "diag": 1e-3*max
    #                                       diag(J'J) (Madsen-Nielsen)
    nu_d: float = 3.0                     # accept decrease factor (`lm.jl:25`)
    nu_m: float = 3.0                     # reject increase factor
    accept_ratio: float = 1e-4            # ared/pred acceptance (`lm.jl:260`)
    good_ratio: float = 0.9               # bonus-decrease threshold
    lam_min: float = 1e-8                 # lambda floor (`lm.jl:337`)
    lam_strategy: str = "ref"             # "ref": the reference's nu_d/nu_m
    #                                       schedule (`lm.jl:306-337`);
    #                                       "nielsen": Madsen-Nielsen-
    #                                       Tingleff gain-ratio-smoothed
    #                                       updates (accept: lam *=
    #                                       max(1/3, 1-(2rho-1)^3); reject:
    #                                       lam *= nu, nu *= 2) — avoids the
    #                                       accept/reject oscillation the
    #                                       ref schedule exhibits near
    #                                       convergence
    linesearch: bool = False              # delta-halving on reject
    ls_max: int = 4                       # max halvings (`lm.jl:263`)
    solver: str = "pcg"                   # "pcg": Schur + block-Jacobi PCG;
    #                                       "dense": Schur + dense Cholesky;
    #                                       "cgls": damped CGLS on J (the
    #                                       QR-path analogue, ops/cgls.py);
    #                                       "power": PBA-style Neumann
    #                                       series (ops/pcg.power_series)
    pcg_rtol: Optional[float] = None      # None -> Eisenstat-Walker forcing
    pcg_max_iters: int = 100
    pcg_warm: bool = False                # warm-start CG from previous dc
    verbose: bool = False
    checkpoint_dir: Optional[str] = None  # rotate step-<n>.npz checkpoints
    checkpoint_every: int = 10
    resume: bool = False                  # restore latest checkpoint first

    def resolved_tols(self, dtype) -> dict:
        eps = float(jnp.finfo(dtype).eps)
        cbrt, sqrt = eps ** (1.0 / 3.0), eps ** 0.5
        return {
            "atol": sqrt if self.atol is None else self.atol,
            "rtol": cbrt if self.rtol is None else self.rtol,
            "restol": cbrt if self.restol is None else self.restol,
            "satol": sqrt if self.satol is None else self.satol,
            "srtol": sqrt if self.srtol is None else self.srtol,
            "oatol": sqrt if self.oatol is None else self.oatol,
            "ortol": cbrt if self.ortol is None else self.ortol,
        }


@dataclasses.dataclass
class LMResult:
    """Mirror of the reference's ``GenericExecutionStats`` (`lm.jl:409-416`)."""
    status: str                     # first_order | small_step | small_residual
    #                                 | small_obj_change | max_iter | max_time
    #                                 | exception
    objective: float
    iterations: int
    elapsed_time: float
    dual_feas: float                # ||J'r|| at the solution
    cams: jnp.ndarray
    points: jnp.ndarray
    neval_residual: int = 0
    neval_jac: int = 0
    history: List[dict] = dataclasses.field(default_factory=list)

    @property
    def rmse_px(self) -> float:
        """Root-mean-square reprojection error in pixels (BASELINE.md)."""
        # objective = 0.5 ||r||^2 over nequ residual components
        return float("nan")  # overwritten by solver with problem context

    def solved(self) -> bool:
        """The reference's "solved" statuses (`src/benchmark.jl:69-86`)."""
        return self.status in ("first_order", "small_residual", "small_step",
                               "small_obj_change")


# ---------------------------------------------------------------------------
# Jitted device kernels shared by both drivers
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("with_jr",))
def _linearize(problem: BAProblem, cams, points, with_jr: bool = True):
    """Residuals + all GN blocks + scalars at the current iterate."""
    blocks = assemble_blocks(problem, cams, points, with_jr=with_jr)
    obj = blocks.obj
    gnorm = gradient_norm(blocks)
    rnorm = jnp.sqrt(2.0 * obj)
    return blocks, obj, gnorm, rnorm


@jax.jit
def _objective_at(problem: BAProblem, cams, points):
    r = residuals(problem, cams, points)
    return 0.5 * jnp.sum(r * r)


@partial(jax.jit, static_argnames=("method", "pcg_max_iters"))
def _compute_step(problem: BAProblem, blocks, lam, pcg_rtol,
                  method: str, pcg_max_iters: int, dc0=None):
    """Damp, reduce, solve for (dc, dp); also return the step's quadratic
    model pieces ``gd = g'd`` and ``Jd2 = ||J d||^2`` so predicted reduction
    at any scaled step ``s*d`` is ``-s*gd - 0.5*s^2*Jd2`` (used by the
    linesearch, cf. the cheap update `lm.jl:277`)."""
    if method == "cgls":
        from bundleadjustment_jl_tpu.ops.cgls import cgls_solve
        res = cgls_solve(problem, blocks, lam, rtol=pcg_rtol,
                         max_iters=pcg_max_iters)
        dc, dp, cg_iters = res.dc, res.dp, res.iters
    elif method == "power":
        # PBA-style Neumann series on the reduced camera system
        from bundleadjustment_jl_tpu.ops.pcg import power_series
        sys = reduce_system(problem, blocks, lam)
        M_inv = block_jacobi_inverse(sys.Hcc_l)
        res = power_series(
            lambda v: schur_matvec(sys, v), sys.b,
            lambda v: jnp.einsum("cab,cb->ca", sys.Hcc_l, v,
                                 precision=jax.lax.Precision.HIGHEST),
            lambda v: block_jacobi_apply(M_inv, v),
            rtol=pcg_rtol, max_terms=pcg_max_iters)
        dc, cg_iters = res.x, res.iters
        dp = back_substitute(sys, dc)
    elif method == "dense":
        sys = reduce_system(problem, blocks, lam)
        dc = solve_dense(sys)
        dp = back_substitute(sys, dc)
        cg_iters = jnp.asarray(0, jnp.int32)
    else:
        sys = reduce_system(problem, blocks, lam)
        M_inv = block_jacobi_inverse(schur_diag_blocks(sys))
        res = pcg(lambda v: schur_matvec(sys, v), sys.b,
                  lambda v: block_jacobi_apply(M_inv, v),
                  rtol=pcg_rtol, max_iters=pcg_max_iters, x0=dc0)
        dc, cg_iters = res.x, res.iters
        dp = back_substitute(sys, dc)
    gd = jnp.sum(blocks.g_c * dc) + jnp.sum(blocks.g_p * dp)
    if method == "cgls":
        from bundleadjustment_jl_tpu.ops.blockmul import jc_dot, jp_dot
        Jd = (jc_dot(blocks.Jc_f, dc[problem.cam_idx])
              + jp_dot(blocks.Jp_f, dp[problem.pnt_idx]))
        Jd2 = jnp.sum(Jd * Jd)
    else:
        from bundleadjustment_jl_tpu.ops.schur import quad_form
        Jd2 = quad_form(problem, blocks, dc, dp)
    dnorm = jnp.sqrt(jnp.sum(dc * dc) + jnp.sum(dp * dp))
    return dc, dp, gd, Jd2, dnorm, cg_iters


def _xnorm(cams, points):
    return jnp.sqrt(jnp.sum(cams ** 2) + jnp.sum(points ** 2))


# ---------------------------------------------------------------------------
# Host-stepped driver
# ---------------------------------------------------------------------------

_LOG_HEADER = (f"{'iter':>5} {'obj':>14} {'‖J′r‖':>11} {'λ':>9} "
               f"{'‖δ‖':>9} {'ρ':>9} {'cg':>4} status")


def levenberg_marquardt(problem: BAProblem,
                        options: Optional[LMOptions] = None,
                        cams=None, points=None,
                        callback: Optional[Callable] = None) -> LMResult:
    """Solve ``min 0.5 ||r(cams, points)||^2`` by Levenberg-Marquardt.

    Host-stepped: per-iteration control flow in Python over jitted device
    kernels. Semantics follow `src/lm.jl` (see module docstring); returns an
    :class:`LMResult` (the reference's ``GenericExecutionStats``).
    """
    opts = options or LMOptions()
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    tols = opts.resolved_tols(problem.dtype)
    if opts.solver not in ("pcg", "dense", "cgls", "power"):
        raise ValueError(f"unknown solver {opts.solver!r}")

    ckpt_mgr = None
    resume_lam = None
    it0 = 0
    if opts.checkpoint_dir is not None:
        from bundleadjustment_jl_tpu.utils.checkpoint import CheckpointManager
        ckpt_mgr = CheckpointManager(opts.checkpoint_dir,
                                     every=opts.checkpoint_every)
        if opts.resume:
            state = ckpt_mgr.restore_latest()
            if state is not None:
                cams = jnp.asarray(state["cams"], problem.dtype)
                points = jnp.asarray(state["points"], problem.dtype)
                resume_lam = state["lam"]
                it0 = state["iteration"]

    t0 = time.perf_counter()
    nres = njac = 0
    with_jr = opts.solver == "cgls"

    blocks, obj, gnorm, rnorm = _linearize(problem, cams, points,
                                           with_jr=with_jr)
    nres += 1
    njac += 1
    obj0, gnorm0 = float(obj), float(gnorm)
    if not np.isfinite(obj0):
        return LMResult("exception", obj0, 0, time.perf_counter() - t0,
                        gnorm0, cams, points, nres, njac, [])

    if resume_lam is not None:
        lam = resume_lam
    elif opts.lam0 is not None:
        lam = float(opts.lam0)
    elif opts.lam0_mode == "diag":
        maxdiag = float(jnp.maximum(
            jnp.max(jnp.einsum("caa->ca", blocks.Hcc)),
            jnp.max(jnp.einsum("paa->pa", blocks.Hpp))))
        lam = 1e-3 * maxdiag
    else:
        lam = max(30.0, 1e10 / max(gnorm0, 1e-300))

    # first_order threshold is fixed at entry (`lm.jl:111-114`)
    gtol = tols["atol"] + tols["rtol"] * gnorm0

    history: List[dict] = []
    status = "max_iter"
    it = it0
    nrejects = 0
    nu = 2.0  # Nielsen reject-growth factor
    dc_prev = None  # PCG warm-start carry (opts.pcg_warm)
    if opts.verbose:
        print(_LOG_HEADER)

    while it < opts.max_iters:
        if time.perf_counter() - t0 > opts.max_time:
            status = "max_time"
            break
        if float(gnorm) < gtol:
            status = "first_order"
            break
        if float(rnorm) < tols["restol"]:
            status = "small_residual"
            break

        pcg_rtol = (opts.pcg_rtol if opts.pcg_rtol is not None
                    else float(forcing_rtol(jnp.asarray(float(gnorm)))))
        dc, dp, gd, Jd2, dnorm, cg_iters = _compute_step(
            problem, blocks, lam, pcg_rtol, opts.solver,
            opts.pcg_max_iters,
            dc0=dc_prev if (opts.pcg_warm and opts.solver == "pcg")
            else None)
        gd, Jd2, dnorm = float(gd), float(Jd2), float(dnorm)
        if opts.pcg_warm and np.isfinite(float(dnorm)):
            dc_prev = dc

        if not np.isfinite(dnorm):
            # NaN step (near-indefinite system at small lambda in low
            # precision): reject and grow lambda instead of the reference's
            # immediate fail2 (`lm.jl:297-302`); terminate only if lambda
            # is already hopeless.
            if lam > 1e20:
                status = "exception"
                break
            nrejects += 1
            if opts.lam_strategy == "nielsen":
                lam *= nu
                nu *= 2.0
            else:
                lam = lam * opts.nu_m
            it += 1
            history.append({"iter": it - 1, "obj": float(obj),
                            "gnorm": float(gnorm), "lam": lam,
                            "dnorm": float("nan"), "rho": float("nan"),
                            "cg_iters": int(cg_iters), "accepted": False})
            continue

        xnorm = float(_xnorm(cams, points))
        if dnorm < tols["satol"] + tols["srtol"] * xnorm:
            status = "small_step"
            break

        # Trial step(s): full step, then optional halvings (`lm.jl:263-295`).
        scales = [1.0]
        if opts.linesearch:
            scales += [0.5 ** j for j in range(1, opts.ls_max + 1)]
        accepted = False
        for s in scales:
            cams_t = cams + s * dc
            points_t = points + s * dp
            obj_t = float(_objective_at(problem, cams_t, points_t))
            nres += 1
            pred = -s * gd - 0.5 * s * s * Jd2
            ared = float(obj) - obj_t
            rho = ared / pred if pred != 0.0 else -np.inf
            if pred > 0 and ared >= opts.accept_ratio * pred:
                accepted = True
                break

        row = {"iter": it, "obj": float(obj), "gnorm": float(gnorm),
               "lam": lam, "dnorm": dnorm * (s if accepted else 1.0),
               "rho": rho, "cg_iters": int(cg_iters),
               "accepted": accepted}
        history.append(row)
        if opts.verbose:
            print(f"{it:5d} {row['obj']:14.6e} {row['gnorm']:11.4e} "
                  f"{lam:9.2e} {row['dnorm']:9.2e} {rho:9.2e} "
                  f"{row['cg_iters']:4d} "
                  f"{'accept' if accepted else 'reject'}")
        if callback is not None:
            callback(row)

        if accepted:
            prev_obj = float(obj)
            cams, points = cams_t, points_t
            blocks, obj, gnorm, rnorm = _linearize(problem, cams, points,
                                                   with_jr=with_jr)
            nres += 1
            njac += 1
            nrejects = 0
            if opts.lam_strategy == "nielsen":
                lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
            else:
                # lambda decrease (`lm.jl:329-337`)
                lam /= opts.nu_d
                if ared >= opts.good_ratio * pred:
                    lam /= opts.nu_d
            lam = max(lam, opts.lam_min)
            it += 1
            if ckpt_mgr is not None:
                ckpt_mgr.maybe_save(it, cams, points, lam=lam,
                                    meta={"objective": float(obj),
                                          "problem": problem.name})
            if (prev_obj - float(obj)
                    < tols["oatol"] + tols["ortol"] * abs(prev_obj)):
                status = "small_obj_change"
                break
        else:
            nrejects += 1
            if opts.lam_strategy == "nielsen":
                lam *= nu
                nu *= 2.0
            else:
                # lambda increase (`lm.jl:306-308`): nu_m^(ntimes+1) with
                # ntimes = halvings tried this iteration (len(scales)-1)
                lam = (max(lam, 1.0 / max(dnorm, 1e-300))
                       * opts.nu_m ** len(scales))
            it += 1

    else:
        status = "max_iter"

    elapsed = time.perf_counter() - t0
    return LMResult(status=status, objective=float(obj), iterations=it,
                    elapsed_time=elapsed, dual_feas=float(gnorm),
                    cams=cams, points=points, neval_residual=nres,
                    neval_jac=njac, history=history)
