"""SPMD reduction context for the solver under `shard_map`.

The spmd driver (`solver/lm_spmd.py`) runs the whole LM loop inside ONE
`shard_map`: every device owns a contiguous, point-aligned shard of the
observations (plus its points), cameras are replicated, and the
camera-space reductions become explicit `psum`s over the mesh axis —
exactly the collective layout SURVEY.md §2.3/§6 prescribes (observation
axis sharded, camera-axis all-reduce over the interconnect).

This module is that axis, as trace-time context. ``AXIS`` is None in
every ordinary path (all hooks are no-ops, zero overhead); the spmd
driver sets it while tracing its shard_map body.

Hook placement (what is local vs replicated inside the shard_map body):

- camera-space assembly outputs [Hcc | g_c], the Schur RHS correction,
  the matvec camera pass, the WCW diagonal: **psum** (replicated after).
- point-space outputs (Hpp, g_p, dp) and the per-observation arrays:
  device-local, never summed.
- scalars mixing both (objective, ||J'r||, ||d||, quad form): the point
  part psums, the camera part is computed redundantly-replicated.
"""

from __future__ import annotations

import jax

# Mesh axis name for the spmd solve; None = single-device /
# GSPMD mode (all hooks no-ops). Set only by solver/lm_spmd.py at trace
# time.
AXIS: str | None = None


def psum(x):
    """All-reduce over the spmd axis (identity when AXIS is None)."""
    return x if AXIS is None else jax.lax.psum(x, AXIS)


def pmax(x):
    return x if AXIS is None else jax.lax.pmax(x, AXIS)
