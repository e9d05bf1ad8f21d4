"""Wall-clock timing helpers: ``Timer``, the pipelined executors'
``StageClock`` and the percentiles of the trace report and the shadow
evaluator (the port's copy of the JAX package's ``utils/timing.py``)."""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Callable

import numpy as np


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.ms``."""

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._start
        self.ms = self.seconds * 1e3


class StageClock:
    """Per-stage busy-time accumulator. Each worker wraps its unit of work
    in ``with clock.stage(name): ...``; ``report(wall_s)`` returns
    ``{stage: {busy_s, items, occupancy}}``, ``occupancy`` being the
    fraction of the pipeline's wall clock the stage spent busy.
    ``sink(name, start_perf_counter, elapsed_s, items)``, when given, is
    called outside the lock for every completed stage execution."""

    def __init__(self, sink: Callable | None = None) -> None:
        self._lock = threading.Lock()
        self._busy: dict[str, float] = {}
        self._items: dict[str, int] = {}
        self._sink = sink

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self._busy[name] = self._busy.get(name, 0.0) + elapsed
                self._items[name] = self._items.get(name, 0) + items
            if self._sink is not None:
                self._sink(name, start, elapsed, items)

    def report(self, wall_s: float) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "busy_s": round(busy, 4),
                    "items": self._items[name],
                    "occupancy": (
                        round(busy / wall_s, 4) if wall_s > 0 else 0.0
                    ),
                }
                for name, busy in self._busy.items()
            }


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list (nan when
    empty): the trace report's."""
    if not sorted_values:
        return float("nan")
    n = len(sorted_values)
    rank = min(n - 1, max(0, math.ceil(q / 100.0 * n) - 1))
    return sorted_values[rank]


def interpolated_percentile(samples, q: float) -> float:
    """numpy's linearly interpolated percentile of unsorted samples in
    f64 (0.0 when empty): the shadow evaluator's mirror latencies."""
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples, np.float64), q))
