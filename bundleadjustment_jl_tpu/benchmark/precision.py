"""Mixed-precision solves: cascades and within-solve low-precision storage.

The JAX counterpart of the reference's precision experiments
(`/root/reference/src/diffprecsions.jl:17-50`,
`src/benchmark_diffprec.jl:38-94`). Two distinct modes, matching the
reference's two:

1. **Cascade** (`precision_cascade`, the "F1632_64" pattern,
   `benchmark_diffprec.jl:46-53`): solve entirely in a cheap low precision
   first, then warm-start progressively higher precisions from the previous
   solution. Low stages get *stage-appropriate* tolerances — bf16's
   eps-derived defaults are trivially satisfiable (eps(bf16)^(1/3) ~ 0.2
   makes `first_order` fire after one iteration), so low stages stop on
   relative objective progress instead and leave the eps-based tests to the
   final stage.

2. **Within-solve low-precision factorization** (`facto_solve`, the
   "F3264" pattern, `lm.jl:99` passing `facto_type` into `ldl_analyse`
   with low-type L storage `ldl_aux.jl:272-282`): the LM loop — residuals,
   gradients, acceptance tests, tolerances — runs in the working dtype
   while the factorization operands (the per-observation ``W`` blocks and
   diagonal Hessian blocks, the bulk of per-iteration device-memory
   traffic) are stored in ``facto_dtype``. Here this is
   ``levenberg_marquardt_jit(..., facto_dtype=bfloat16)``: bf16 storage,
   f32 accumulation, ~half the bytes through the PCG matvec.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit)

_DEFAULT_STAGES = ("bfloat16", "float32")

# Low-precision stages stop on objective progress (0.1 %/iteration), not on
# the dtype-eps first-order/step tests (see module docstring); the final
# stage applies whatever the caller's tolerances are.
_LOW_STAGE_TOLS = dict(atol=0.0, rtol=1e-3, satol=0.0, srtol=0.0,
                       oatol=0.0, ortol=1e-3)
_LOW_DTYPES = ("bfloat16", "float16")


def facto_bytes(problem: BAProblem, facto_dtype=None, work_dtype=None
                ) -> int:
    """Bytes of the factorization-operand storage the `facto_dtype` option
    shrinks (the per-observation ``W`` blocks; the small diagonal blocks
    stay full-precision — see solver.lm_jit._maybe_cast_facto). One PCG
    matvec reads ~2x this."""
    wd = jnp.dtype(work_dtype or problem.dtype)
    fd = jnp.dtype(facto_dtype) if facto_dtype is not None else wd
    return fd.itemsize * 27 * problem.nobs_pad


def precision_cascade(problem: BAProblem,
                      stages: Sequence[str] = _DEFAULT_STAGES,
                      max_iters: int = 100, pcg_max_iters: int = 100,
                      **lm_kwargs) -> List[dict]:
    """Run the warm-started cascade; returns one stats row per stage.

    Non-final stages in a dtype from ``_LOW_DTYPES`` get the progress-based
    tolerance overrides; the final stage uses the caller's ``lm_kwargs``
    verbatim. The final stage's (cams, points) are returned inside the last
    row under ``"cams"``/``"points"``.
    """
    import time

    cams, points = problem.cams, problem.points
    rows: List[dict] = []
    for i, stage in enumerate(stages):
        dtype = jnp.dtype(stage)
        p = problem.astype(dtype)
        c0 = cams.astype(dtype)
        x0 = points.astype(dtype)
        kwargs = dict(lm_kwargs)
        if i < len(stages) - 1 and stage in _LOW_DTYPES:
            kwargs.update(_LOW_STAGE_TOLS)
        t0 = time.perf_counter()
        res = levenberg_marquardt_jit(
            p, cams=c0, points=x0, max_iters=max_iters,
            pcg_max_iters=pcg_max_iters, **kwargs)
        obj = float(res.objective)       # device fetch = true barrier
        elapsed = time.perf_counter() - t0
        cams, points = res.cams, res.points
        rows.append({
            "stage": stage,
            "status": STATUS_NAMES[int(res.status)],
            "objective": obj,
            "iterations": int(res.iterations),
            "neval_residual": res.neval_residual,
            "neval_jac": res.neval_jac,
            "elapsed_s": elapsed,
            "dual_feas": float(res.dual_feas),
            "facto_bytes": facto_bytes(problem, work_dtype=dtype),
        })
    rows[-1]["cams"] = cams
    rows[-1]["points"] = points
    return rows


def facto_solve(problem: BAProblem, facto_dtype="bfloat16",
                max_iters: int = 100, pcg_max_iters: int = 100,
                **lm_kwargs) -> dict:
    """Within-solve mixed precision (the reference's F3264 role): one solve
    in the problem's working dtype with low-precision factorization
    storage. Returns a stats row including the storage-byte saving."""
    import time

    t0 = time.perf_counter()
    res = levenberg_marquardt_jit(
        problem, max_iters=max_iters, pcg_max_iters=pcg_max_iters,
        facto_dtype=facto_dtype, **lm_kwargs)
    obj = float(res.objective)
    elapsed = time.perf_counter() - t0
    return {
        "stage": f"{jnp.dtype(problem.dtype).name}"
                 f"+{jnp.dtype(facto_dtype).name}facto",
        "status": STATUS_NAMES[int(res.status)],
        "objective": obj,
        "iterations": int(res.iterations),
        "neval_residual": res.neval_residual,
        "neval_jac": res.neval_jac,
        "elapsed_s": elapsed,
        "dual_feas": float(res.dual_feas),
        "facto_bytes": facto_bytes(problem, facto_dtype=facto_dtype),
        "facto_bytes_full": facto_bytes(problem),
    }
