"""Multi-device LM with explicit collectives: one `shard_map` solve.

`solver/lm_jit.py` is the single-device driver; `parallel/mesh.py` is the
GSPMD scale-out path (XLA partitions the scatter/gather formulation).
This driver combines them: the WHOLE jitted LM loop (same `_lm_*_impl`
body — lambda schedule, acceptance, stopping tests) runs inside ONE
`shard_map` over a 1-D device mesh, so every device runs the XLA
formulation on its own point-aligned shard (`parallel/spmd.py`) while
the camera-space reductions `psum` over the mesh axis
(`ops/spmdctx.py`).

What is local vs replicated:

- per-observation arrays, points, Hpp, g_p, dp: device-local;
- cameras, Hcc, g_c, the reduced RHS/matvec results, PCG state, the
  lambda/acceptance scalars: replicated (psum-derived) — every device
  runs the identical scalar control flow, so the `lax.while_loop`
  stays in lockstep with zero divergence by construction.

Collective footprint per LM iteration: one (ncams, 90) psum at
assembly, one (ncams, 9) psum per CG matvec, one (ncams, 81) psum for
the preconditioner diagonal, plus O(1) scalar psums — all camera-space,
riding the interconnect (SURVEY.md §2.3: `reduce_scatter`/`all_reduce` over the
camera axis is the prescribed collective layout; here sum-replicate,
since PCG needs the full reduced system on every device).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from bundleadjustment_jl_tpu.models.problem import BAProblem
from bundleadjustment_jl_tpu.ops import spmdctx
from bundleadjustment_jl_tpu.ops.normal import GNBlocks
from bundleadjustment_jl_tpu.parallel.spmd import (
    SPMD_AXIS, ShardStack, SpmdProblem)
from bundleadjustment_jl_tpu.solver.lm_jit import (
    LMJitResult, MAX_ITER, MAX_TIME, RUNNING, STATUS_NAMES, _lm_init_impl,
    _lm_run_impl, _resolve_hp)


_CACHE: dict = {}


def _local_solve(arrs: ShardStack, hp, lam0, *, statics, has_lam0):
    """Per-device body: rebuild the local BAProblem and run the shared
    LM implementation; spmdctx hooks supply the cross-device sums."""
    PL = arrs.points.shape[1]
    lp = _local_problem(arrs)
    state = _lm_init_impl(lp, lp.cams, lp.points, hp, **statics)
    if has_lam0:
        state = dict(state, lam=lam0.astype(state["lam"].dtype))
    st = _lm_run_impl(lp, state, hp, **statics)
    return dict(
        cams=st["cams"].reshape(-1, 9),
        points=st["points"].reshape(1, PL, 3),
        obj=st["obj"], gnorm=st["gnorm"], it=st["it"],
        status=st["status"], naccepts=st["naccepts"],
        hist_obj=st["hist_obj"], hist_gnorm=st["hist_gnorm"],
        hist_lam=st["hist_lam"], hist_cg=st["hist_cg"])


def _state_specs(facto_dtype):
    """PartitionSpec tree for the solver-state dict crossing the
    shard_map boundary (chunked driver): point-space leaves ride the
    mesh axis on dim 0, everything else is replicated.  f16 W storage
    carries its range scale (a replicated scalar)."""
    obs, rep = P(SPMD_AXIS), P()
    w_scale = rep if facto_dtype == "float16" else None
    blocks = GNBlocks(g_c_f=rep, g_p_f=obs, Hcc_f=rep, Hpp_f=obs,
                      W_f=obs, obj=rep, r_f=None, Jc_f=None,
                      Jp_f=None, w_scale=w_scale)
    return dict(cams=rep, points=obs, blocks=blocks, obj=rep, gnorm=rep,
                lam=rep, it=rep, it_max=rep, gtol=rep, nrejects=rep,
                naccepts=rep, dc=rep, nu=rep, status=rep,
                hist_obj=rep, hist_gnorm=rep, hist_lam=rep, hist_cg=rep)


def _local_problem(arrs: ShardStack) -> BAProblem:
    M = arrs.cam_idx.shape[1]
    PL = arrs.points.shape[1]
    return BAProblem(
        cams=arrs.cams, points=arrs.points.reshape(PL, 3),
        cam_idx=arrs.cam_idx.reshape(M), pnt_idx=arrs.pnt_idx.reshape(M),
        pt2d=arrs.pt2d.reshape(M, 2), w=arrs.w.reshape(M),
        nobs=M, name="spmd-shard",
        pnt_starts=arrs.pnt_starts.reshape(-1),
        cam_perm=arrs.cam_perm.reshape(M),
        cam_starts=arrs.cam_starts.reshape(-1))


def _get_chunked_fns(mesh, statics, has_lam0):
    """(init_fn, seg_fn) for the chunked spmd driver: the solver state
    crosses the shard_map boundary between segments (specs above)."""
    key = ("chunked", mesh, tuple(sorted(statics.items())), has_lam0)
    fns = _CACHE.get(key)
    if fns is not None:
        return fns
    obs, rep = P(SPMD_AXIS), P()
    in_arr_specs = ShardStack(rep, *([obs] * (len(ShardStack._fields) - 1)))
    st_specs = _state_specs(statics["facto_dtype"])

    def init_body(arrs, hp, lam0):
        lp = _local_problem(arrs)
        state = _lm_init_impl(lp, lp.cams, lp.points, hp, **statics)
        if has_lam0:
            state = dict(state, lam=lam0.astype(state["lam"].dtype))
        return state

    def seg_body(arrs, state, hp):
        return _lm_run_impl(_local_problem(arrs), state, hp, **statics)

    init_fn = jax.jit(shard_map(
        init_body, mesh=mesh, in_specs=(in_arr_specs, rep, rep),
        out_specs=st_specs, check_vma=False))
    seg_fn = jax.jit(shard_map(
        seg_body, mesh=mesh, in_specs=(in_arr_specs, st_specs, rep),
        out_specs=st_specs, check_vma=False))
    _CACHE[key] = (init_fn, seg_fn)
    return init_fn, seg_fn


def _get_fn(mesh, statics, has_lam0):
    key = (mesh, tuple(sorted(statics.items())), has_lam0)
    fn = _CACHE.get(key)
    if fn is not None:
        return fn
    obs = P(SPMD_AXIS)
    rep = P()
    in_arr_specs = ShardStack(rep, *([obs] * (len(ShardStack._fields) - 1)))
    out_specs = dict(
        cams=rep, points=obs, obj=rep, gnorm=rep, it=rep, status=rep,
        naccepts=rep, hist_obj=rep, hist_gnorm=rep, hist_lam=rep,
        hist_cg=rep)
    body = partial(_local_solve, statics=statics, has_lam0=has_lam0)
    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(in_arr_specs, rep, rep),
        out_specs=out_specs, check_vma=False))
    _CACHE[key] = fn
    return fn


def _statics(max_iters, pcg_max_iters, linesearch, ls_max, lam0_mode,
             pcg_rtol, facto_dtype, pcg_warm) -> dict:
    """The static (jit-key) options of the shared LM body."""
    from bundleadjustment_jl_tpu.ops import gatherfree, segsum
    return dict(max_iters=max_iters, pcg_max_iters=pcg_max_iters,
                use_dense=False, use_cgls=False, use_power=False,
                linesearch=linesearch, ls_max=ls_max,
                lam0_mode=lam0_mode, use_forcing=pcg_rtol is None,
                facto_dtype=(None if facto_dtype is None
                             else jnp.dtype(facto_dtype).name),
                pcg_warm=pcg_warm, gather_mode=gatherfree.MODE,
                sorted_mode=segsum.SORTED_MODE,
                # shard-local rows inside the shard_map: the streamed
                # forms scan each device's own rows
                obs_sharded=False)


def levenberg_marquardt_spmd(
    sp: SpmdProblem, mesh, *,
    max_iters: int = 200,
    lam0=None, lam0_mode: str = "ref",
    atol=None, rtol=None, restol=None, satol=None, srtol=None,
    oatol=None, ortol=None,
    nu_d=3.0, nu_m=3.0, accept_ratio=1e-4, good_ratio=0.9, lam_min=1e-8,
    lam_strategy: str = "ref",
    pcg_rtol=None, pcg_max_iters: int = 100,
    linesearch: bool = False, ls_max: int = 4,
    facto_dtype=None, pcg_warm: bool = False,
) -> LMJitResult:
    """LM over a device mesh (one shard_map; point-aligned
    :class:`SpmdProblem` from `shard_problem_spmd`). Same options as
    :func:`levenberg_marquardt_jit` (PCG solver only — it is the scale
    configuration). Every device runs the XLA formulation on its shard;
    the camera-space reductions carry spmdctx psum hooks. Any working
    dtype, f64 included."""
    ndev_mesh = int(mesh.devices.size)
    if sp.ndev != ndev_mesh:
        raise ValueError(f"SpmdProblem has {sp.ndev} shards but the mesh "
                         f"has {ndev_mesh} devices — rebuild with "
                         f"shard_problem_spmd(problem, {ndev_mesh})")
    dtype = sp.arrays.cams.dtype
    hp = _resolve_hp(dtype, atol, rtol, restol, satol, srtol, oatol,
                     ortol, nu_d, nu_m, accept_ratio, good_ratio, lam_min,
                     pcg_rtol, lam_strategy)
    statics = _statics(max_iters, pcg_max_iters, linesearch, ls_max,
                       lam0_mode, pcg_rtol, facto_dtype, pcg_warm)
    has_lam0 = lam0 is not None
    lam0_val = jnp.asarray(0.0 if lam0 is None else lam0, dtype)
    fn = _get_fn(mesh, statics, has_lam0)
    spmdctx.AXIS = SPMD_AXIS
    try:
        out = fn(sp.arrays, hp, lam0_val)
    finally:
        spmdctx.AXIS = None
    status = int(out["status"])
    if status == RUNNING:
        status = MAX_ITER
    return LMJitResult(
        cams=out["cams"], points=sp.global_points(out["points"]),
        objective=out["obj"], dual_feas=out["gnorm"],
        iterations=out["it"], status=jnp.asarray(status, jnp.int32),
        hist_obj=out["hist_obj"], hist_gnorm=out["hist_gnorm"],
        hist_lam=out["hist_lam"], hist_cg=out["hist_cg"],
        naccepts=out["naccepts"])


def levenberg_marquardt_spmd_chunked(
    sp: SpmdProblem, mesh, *,
    max_iters: int = 200,
    chunk_iters: int = 25,
    max_time=None,
    checkpoint_dir=None,
    checkpoint_every: int = 1,
    resume: bool = False,
    callback=None,
    lam0=None, lam0_mode: str = "ref",
    atol=None, rtol=None, restol=None, satol=None, srtol=None,
    oatol=None, ortol=None,
    nu_d=3.0, nu_m=3.0, accept_ratio=1e-4, good_ratio=0.9, lam_min=1e-8,
    lam_strategy: str = "ref",
    pcg_rtol=None, pcg_max_iters: int = 100,
    linesearch: bool = False, ls_max: int = 4,
    facto_dtype=None, pcg_warm: bool = False,
) -> LMJitResult:
    """Chunked multi-device LM: the shard_map segment kernel runs
    ``chunk_iters`` iterations; the host checks wall clock, writes
    checkpoints (cams + GLOBAL points, re-split on resume) and invokes
    ``callback`` between segments — `levenberg_marquardt_jit_chunked`'s
    capabilities (max_time, checkpoint/resume) for the spmd path."""
    import time as _time

    if sp.ndev != int(mesh.devices.size):
        raise ValueError(f"SpmdProblem has {sp.ndev} shards, mesh has "
                         f"{int(mesh.devices.size)} devices")
    dtype = sp.arrays.cams.dtype
    hp = _resolve_hp(dtype, atol, rtol, restol, satol, srtol, oatol,
                     ortol, nu_d, nu_m, accept_ratio, good_ratio, lam_min,
                     pcg_rtol, lam_strategy)
    statics = _statics(max_iters, pcg_max_iters, linesearch, ls_max,
                       lam0_mode, pcg_rtol, facto_dtype, pcg_warm)
    arrs = sp.arrays

    ckpt_mgr = None
    restored = None
    if checkpoint_dir is not None:
        from bundleadjustment_jl_tpu.utils.checkpoint import (
            CheckpointManager)
        ckpt_mgr = CheckpointManager(checkpoint_dir, every=1)
        if resume:
            restored = ckpt_mgr.restore_latest()
            if restored is not None:
                arrs = arrs._replace(
                    cams=jnp.asarray(restored["cams"], dtype),
                    points=sp.split_points(restored["points"]))

    has_lam0 = lam0 is not None
    lam0_val = jnp.asarray(0.0 if lam0 is None else lam0, dtype)
    init_fn, seg_fn = _get_chunked_fns(mesh, statics, has_lam0)

    t0 = _time.perf_counter()
    spmdctx.AXIS = SPMD_AXIS
    try:
        state = init_fn(arrs, hp, lam0_val)
        if restored is not None:
            state = dict(
                state,
                lam=jnp.asarray(restored["lam"], dtype),
                it=jnp.asarray(restored["iteration"], jnp.int32))
            gtol = restored["meta"].get("gtol")
            if gtol is not None:
                state["gtol"] = jnp.asarray(gtol, dtype)

        final_status = None
        nchunk = 0
        while True:
            it = int(state["it"])
            if int(state["status"]) != RUNNING or it >= max_iters:
                break
            if (max_time is not None
                    and _time.perf_counter() - t0 > max_time):
                final_status = MAX_TIME
                break
            state = dict(state, it_max=jnp.asarray(
                min(it + chunk_iters, max_iters), jnp.int32))
            state = seg_fn(arrs, state, hp)
            nchunk += 1
            if (ckpt_mgr is not None
                    and nchunk % max(1, checkpoint_every) == 0):
                pts_g = sp.global_points(
                    state["points"].reshape(sp.ndev, -1, 3))
                ckpt_mgr.maybe_save(
                    int(state["it"]), state["cams"].reshape(-1, 9),
                    pts_g, lam=float(state["lam"]),
                    meta={"objective": float(state["obj"]),
                          "gtol": float(state["gtol"]),
                          "problem": sp.name})
            if callback is not None:
                callback({"iter": int(state["it"]),
                          "obj": float(state["obj"]),
                          "gnorm": float(state["gnorm"]),
                          "lam": float(state["lam"]),
                          "status": STATUS_NAMES[int(state["status"])],
                          "elapsed": _time.perf_counter() - t0})
    finally:
        spmdctx.AXIS = None

    status = int(state["status"])
    if status == RUNNING:
        status = MAX_ITER if final_status is None else final_status
    return LMJitResult(
        cams=state["cams"].reshape(-1, 9),
        points=sp.global_points(state["points"].reshape(sp.ndev, -1, 3)),
        objective=state["obj"], dual_feas=state["gnorm"],
        iterations=state["it"], status=jnp.asarray(status, jnp.int32),
        hist_obj=state["hist_obj"], hist_gnorm=state["hist_gnorm"],
        hist_lam=state["hist_lam"], hist_cg=state["hist_cg"],
        naccepts=state["naccepts"],
        elapsed_time=_time.perf_counter() - t0)
