"""Segmented reduction without scatter.

`jax.ops.segment_sum` lowers to XLA scatter-add. With observations SORTED
by segment (done once, host-side, at problem build), a segment sum becomes

    z = exclusive_prefix_sum(values)        # parallel scan, log-depth
    out[s] = z[starts[s+1]] - z[starts[s]]  # two gathers

— pure gather + scan, bandwidth-bound, no scatter anywhere.

f32 caveat: a plain f32 prefix sum carries absolute error ~ eps * |prefix|,
which for millions of observations swamps small per-segment totals. The
scan therefore runs in **double-single (compensated) arithmetic** by
default for f32 — each partial sum is an unevaluated (hi, lo) pair with
~49 effective mantissa bits, combined with an error-free two-sum inside
`jax.lax.associative_scan`. Costs ~6 adds per element instead of 1; still
far cheaper than scatter.

The scatter path remains as `segment_sum_scatter` for unsorted layouts
(e.g. after `partition_problem`'s per-part padding).

The scan path is OFF by default (``SORTED_MODE = False``): the scatter
form was the faster one before the H100 port, and the choice is not
measured on the H100 (ROADMAP D2). The associative scan also inflates
compile time (log-depth unrolled HLO over (nobs, 81) arrays).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Global switch: True -> use the sorted prefix-scan path when layout
# metadata is available; False -> always scatter.
SORTED_MODE = False


def _two_sum(a, b):
    """Knuth error-free transformation: a + b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _add_ds(x, y):
    """Double-single addition (associative to working precision)."""
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    lo = e + xl + yl
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


def prefix_sum(values: jnp.ndarray, compensated: bool = True) -> jnp.ndarray:
    """Inclusive prefix sum along axis 0, optionally compensated."""
    if not compensated:
        return jnp.cumsum(values, axis=0)
    hi, lo = jax.lax.associative_scan(
        _add_ds, (values, jnp.zeros_like(values)), axis=0)
    return hi + lo


def _pad0(x):
    return jnp.concatenate(
        [jnp.zeros((1,) + x.shape[1:], x.dtype), x], axis=0)


def sorted_segment_sum(values: jnp.ndarray, starts: jnp.ndarray,
                       compensated: bool | None = None) -> jnp.ndarray:
    """Sum ``values`` (n, d...) over segments given by ``starts``
    (nseg + 1,), where rows [starts[s], starts[s+1]) belong to segment s
    (rows must be sorted by segment; starts[-1] == n).

    ``compensated=None`` -> compensated for f32/bf16, plain for f64.
    The boundary differences are taken in the unevaluated (hi, lo)
    representation: hi[e] - hi[s] is exact by Sterbenz (the two prefixes
    are within a factor 2), so per-segment accuracy is ~1 ulp of the
    segment value itself, independent of the global prefix magnitude.
    """
    if compensated is None:
        compensated = values.dtype in (jnp.float32, jnp.bfloat16)
    work = values.astype(jnp.float32) if values.dtype == jnp.bfloat16 \
        else values
    if not compensated:
        z = _pad0(jnp.cumsum(work, axis=0))
        out = z[starts[1:]] - z[starts[:-1]]
        return out.astype(values.dtype)
    hi, lo = jax.lax.associative_scan(
        _add_ds, (work, jnp.zeros_like(work)), axis=0)
    zh, zl = _pad0(hi), _pad0(lo)
    out = ((zh[starts[1:]] - zh[starts[:-1]])
           + (zl[starts[1:]] - zl[starts[:-1]]))
    return out.astype(values.dtype)


def segment_sum_scatter(values: jnp.ndarray, seg_ids: jnp.ndarray,
                        num_segments: int) -> jnp.ndarray:
    """Scatter-add fallback for unsorted layouts."""
    return jax.ops.segment_sum(values, seg_ids, num_segments=num_segments)


def make_starts(seg_ids, num_segments: int, total: int):
    """Host-side: starts array (nseg+1,) for rows sorted by ``seg_ids``.

    ``total`` is the padded row count; trailing padding rows must carry
    segment id ``num_segments - 1`` (their values are zero, so including
    them in the last segment is exact).
    """
    import numpy as np
    ids = np.asarray(seg_ids)
    starts = np.searchsorted(ids, np.arange(num_segments + 1)).astype(
        np.int32)
    starts[-1] = total
    return starts
