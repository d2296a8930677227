"""Tracing / profiling.

The reference profiles with ad-hoc ``time()`` + ``@info`` pairs around the
factorization (`/root/reference/src/lm.jl:124-126,160-162,182-185`) and
``@btime`` micro-benchmarks (`src/CUTEst_compare.jl:17-23`).
Equivalents here:

- :class:`PhaseTimers` — named accumulating wall timers that force device
  completion (`block_until_ready`) so phases are attributed correctly
  despite async dispatch.
- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace (XLA op-level timeline).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import jax


class PhaseTimers:
    """Accumulate wall time per named phase.

    >>> timers = PhaseTimers()
    >>> with timers.phase("linearize"):
    ...     blocks = assemble_blocks(problem)   # doctest: +SKIP
    >>> timers.summary()                        # doctest: +SKIP
    """

    def __init__(self, sync: bool = True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, result=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                jax.block_until_ready(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn``, block on its result, charge the elapsed time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            jax.block_until_ready(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<24} {'total s':>10} {'calls':>7} "
                 f"{'mean ms':>9} {'%':>6}"]
        for name, t in rows:
            n = self.counts[name]
            lines.append(f"{name:<24} {t:10.3f} {n:7d} "
                         f"{1e3 * t / n:9.3f} {100 * t / total:6.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """XLA op-level trace (view with TensorBoard's profile plugin)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
