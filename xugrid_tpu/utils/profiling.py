"""
Tracing and per-kernel cost accounting.

The reference has no observability at all (SURVEY.md §5 "green-field");
this module provides two tools:

* ``trace(logdir)``: context manager around the JAX profiler, producing
  TensorBoard-compatible device traces;
* ``timings`` / ``timed``: a lightweight wall-clock registry for the
  host-side stages (index builds, candidate joins, file I/O) that the
  device profiler cannot see.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class TimingRegistry:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self):
        self._records: Dict[str, list] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            record = self._records[name]
            record[0] += 1
            record[1] += time.perf_counter() - t0

    def record(self, name: str, seconds: float) -> None:
        record = self._records[name]
        record[0] += 1
        record[1] += seconds

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "count": count,
                "total_s": round(total, 6),
                "mean_s": round(total / count, 6) if count else 0.0,
            }
            for name, (count, total) in sorted(
                self._records.items(), key=lambda kv: -kv[1][1]
            )
        }

    def reset(self) -> None:
        self._records.clear()

    def report(self) -> str:
        lines = [f"{'stage':<40} {'count':>8} {'total s':>10} {'mean s':>10}"]
        for name, stats in self.summary().items():
            lines.append(
                f"{name:<40} {stats['count']:>8} {stats['total_s']:>10.4f} "
                f"{stats['mean_s']:>10.6f}"
            )
        return "\n".join(lines)


#: Global registry used by the framework's instrumented stages.
timings = TimingRegistry()
timed = timings.timed


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a JAX device profile (TensorBoard trace) for the block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the device trace (jax.profiler.TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
