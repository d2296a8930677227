"""Device mesh + sharding layout for bundle adjustment.

Layout (the "how to scale" recipe — pick a mesh, annotate shardings, let XLA
insert collectives):

- ``cam_idx``/``pnt_idx``/``pt2d``/``w`` — sharded along the observation
  axis (mesh axis ``"obs"``). All per-observation compute (residuals,
  Jacobian blocks, W blocks, trial objectives) is then embarrassingly
  device-local.
- ``cams``/``points`` — replicated. Gathers ``cams[cam_idx]`` are local;
  ``segment_sum`` into camera/point space becomes a partial sum + psum
  placed by the SPMD partitioner over the interconnect.
- PCG state (ncams, 9) — replicated; each Schur matvec does sharded
  per-observation products and an all-reduce.

This is data parallelism over the residual axis — the moral equivalent of
sequence parallelism for BA (SURVEY.md §6): the 9M-residual Venice axis
partitions across chips, camera-space reductions ride the interconnect.

Everything downstream (`ops/*`, `solver/*`) is sharding-agnostic: the same
jitted code runs single-chip or on any mesh, because sharding is carried by
the arrays (GSPMD), not by the program.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bundleadjustment_jl_tpu.models.problem import BAProblem

OBS_AXIS = "obs"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = OBS_AXIS) -> Mesh:
    """1-D device mesh over the observation axis.

    Uses the first ``n_devices`` available devices (all by default).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_problem(problem: BAProblem, mesh: Mesh,
                  axis_name: str = OBS_AXIS) -> BAProblem:
    """Place a problem on the mesh: observation arrays sharded, state
    replicated. ``nobs_pad`` must divide by the mesh size (guaranteed for
    ``pad_obs_to`` a multiple of the device count)."""
    n = mesh.devices.size
    if problem.nobs_pad % n != 0:
        raise ValueError(
            f"nobs_pad={problem.nobs_pad} not divisible by mesh size {n}; "
            f"rebuild the problem with pad_obs_to a multiple of {n}")
    obs_sh = NamedSharding(mesh, P(axis_name))
    rep_sh = NamedSharding(mesh, P())

    def put(x, sh):
        # make_array_from_callback works in BOTH single- and multi-process
        # settings (each process supplies only its addressable shards),
        # where device_put would reject non-addressable devices. This is
        # the jax.distributed path for multi-host meshes (SURVEY.md §2.3).
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, sh,
                                            lambda idx: xh[idx])

    def put_opt(x, sh):
        return None if x is None else put(x, sh)

    # Sorted-layout metadata travels too (VERDICT r1 #7): permutations are
    # per-observation (sharded); starts arrays are global offsets
    # (replicated — small, npnts+1 / ncams+1 int32).
    return BAProblem(
        cams=put(problem.cams, rep_sh),
        points=put(problem.points, rep_sh),
        cam_idx=put(problem.cam_idx, obs_sh),
        pnt_idx=put(problem.pnt_idx, obs_sh),
        pt2d=put(problem.pt2d, obs_sh),
        w=put(problem.w, obs_sh),
        nobs=problem.nobs, name=problem.name,
        pnt_starts=put_opt(problem.pnt_starts, rep_sh),
        cam_perm=put_opt(problem.cam_perm, obs_sh),
        cam_starts=put_opt(problem.cam_starts, rep_sh),
        pnt_perm=put_opt(problem.pnt_perm, obs_sh))
