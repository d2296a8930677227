"""Gather-free row indexing.

Written for an accelerator whose row gathers were slow; the LM inner loop
performs several gathers per PCG matvec. Chosen before the H100 port and
not measured on the H100, where gathers are native (ROADMAP D2); the
default ``MODE`` is "native" indexing. The two formulations here express
the same row-indexing without per-row indexing:

- :func:`take_rows_onehot` — ``out = onehot(idx) @ table`` as a matmul,
  chunked through a `lax.map` so the transient one-hot stays a few MB.
  EXACT: the one-hot is 0/1 in the working dtype and the dot runs at
  ``Precision.HIGHEST`` with exactly one nonzero term per output row.
  Economical when the table is small (camera-indexed quantities: the
  cost is ~4*ncams bytes/row of one-hot traffic).
- :func:`expand_sorted` — for NONDECREASING index vectors (the
  point-sorted observation layout invariant): scatter the per-row deltas
  ``t[p] - t[p-1]`` at segment starts and prefix-sum over the observation
  axis (telescoping identity ``t[idx[k]] == cumsum(seed)[k]``). One small
  scatter + one cumsum; no per-row indexing at all. Exactness: the
  telescoping sum reintroduces ~eps-level cancellation error per element
  (bounded by segment count x eps x max|t|); acceptable inside the PCG
  matvec whose outer LM acceptance test is evaluated exactly.

The module-level ``MODE`` switches call sites (ops/schur.py,
ops/residuals.py, ops/jacobian.py) between "native" jnp indexing and the
gather-free forms; `set_mode` flips it globally (benchmarks compare both).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# "native" -> plain x[idx]; "gatherfree" -> the formulations above.
MODE = "native"

# transient one-hot chunk (rows); keeps the (chunk, M) one-hot a few MB
ONEHOT_CHUNK = 8192


def set_mode(mode: str) -> None:
    global MODE
    if mode not in ("native", "gatherfree"):
        raise ValueError(mode)
    MODE = mode


def take_rows_onehot(table: jnp.ndarray, idx: jnp.ndarray,
                     chunk: int = None) -> jnp.ndarray:
    """``table[idx]`` as chunked one-hot matmuls (exact)."""
    chunk = ONEHOT_CHUNK if chunk is None else chunk
    M, d = table.shape
    n = idx.shape[0]
    iota = jnp.arange(M, dtype=idx.dtype)

    def one(idx_c):
        oh = (idx_c[:, None] == iota[None, :]).astype(table.dtype)
        return jnp.dot(oh, table, precision=jax.lax.Precision.HIGHEST)

    if n <= chunk:
        return one(idx)
    npad = (-n) % chunk
    idx_p = jnp.concatenate([idx, jnp.zeros((npad,), idx.dtype)])
    out = jax.lax.map(one, idx_p.reshape(-1, chunk))
    return out.reshape(-1, d)[:n]


def expand_sorted(table: jnp.ndarray, starts: jnp.ndarray,
                  total: int) -> jnp.ndarray:
    """``table[idx]`` for sorted ``idx`` given segment ``starts``
    (M+1,), where rows [starts[p], starts[p+1]) carry ``table[p]``.

    Rows past ``starts[-1]`` (trailing padding) repeat the last row —
    harmless downstream (padding is zero-weighted). Empty segments are
    handled exactly (their deltas accumulate onto the same seed row).
    """
    d = table.shape[-1]
    delta = table - jnp.concatenate(
        [jnp.zeros((1, d), table.dtype), table[:-1]], axis=0)
    seed = jnp.zeros((total, d), table.dtype).at[starts[:-1]].add(
        delta, mode="drop")
    return jnp.cumsum(seed, axis=0)


# ---------------------------------------------------------------------------
# Mode-dispatching facades used by the ops layer
# ---------------------------------------------------------------------------

def take_cam(table: jnp.ndarray, cam_idx: jnp.ndarray) -> jnp.ndarray:
    """Camera-indexed rows (unsorted idx, small table)."""
    if MODE == "gatherfree":
        return take_rows_onehot(table, cam_idx)
    return table[cam_idx]


def take_pnt(table: jnp.ndarray, pnt_idx: jnp.ndarray,
             pnt_starts: jnp.ndarray | None,
             pnt_perm: jnp.ndarray | None = None) -> jnp.ndarray:
    """Point-indexed rows. Uses the sorted expansion when the layout is
    point-sorted (``pnt_starts`` present, no permutation); falls back to
    native indexing otherwise (e.g. partitioned layouts)."""
    if (MODE == "gatherfree" and pnt_starts is not None
            and pnt_perm is None):
        shaped = table.reshape(table.shape[0], -1)
        out = expand_sorted(shaped, pnt_starts, pnt_idx.shape[0])
        return out.reshape((pnt_idx.shape[0],) + table.shape[1:])
    return table[pnt_idx]
