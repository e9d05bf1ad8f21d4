"""Bounded, drop-counting span sink flushed to JSONL by a writer thread.

The hot path calls ``record(dict)``: one lock-guarded deque append, never
a syscall, never blocking — a full buffer DROPS the record and counts it
(``dropped`` / the ``on_drop`` hook feeds ``mlops_tpu_trace_dropped_total``)
instead of ever back-pressuring the serving path. A background writer
drains the buffer every ``flush_interval_s`` and on ``close()``.

Write discipline (the utils/io.py atomic/append family): every record is
ONE ``os.write`` of one newline-terminated line on an ``O_APPEND`` fd —
appends of a single write are not interleaved by the kernel, so a reader
(or a SIGTERM arriving between lines) never sees a torn record, and N
worker processes appending to their own per-worker files never
coordinate at all.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Callable

logger = logging.getLogger("mlops_tpu_torch.trace")

# Lock layout: one leaf lock guarding only the deque and the drop counter.
# The writer thread drains under the lock (a popleft loop of index moves)
# and performs the json.dumps + os.write OUTSIDE it — file I/O under a
# hot-path lock is what this layout avoids.


class TraceRecorder:
    """One process's span sink -> one JSONL file."""

    def __init__(
        self,
        path: str | Path,
        capacity: int = 4096,
        flush_interval_s: float = 0.5,
        on_drop: Callable[[int], None] | None = None,
    ) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque()
        self.dropped = 0
        self._on_drop = on_drop
        self._closed = False
        self._wake = threading.Event()
        self._writer = threading.Thread(
            target=self._run, name="trace-writer", daemon=True
        )
        self._flush_interval_s = max(0.01, float(flush_interval_s))
        self._writer.start()

    # ------------------------------------------------------------ hot path
    def record(self, record: dict[str, Any]) -> None:
        """Non-blocking enqueue; a full buffer drops + counts."""
        with self._lock:
            if self._closed or len(self._buf) >= self.capacity:
                self.dropped += 1
                dropped = True
            else:
                self._buf.append(record)
                dropped = False
        if dropped and self._on_drop is not None:
            # Outside the lock: the hook may touch shm/metrics state with
            # its own discipline.
            self._on_drop(1)

    def stage_sink(self, source: str) -> Callable[[str, float, float, int], None]:
        """A `utils/timing.StageClock` sink: pipeline/bulk stage timings
        land in the same JSONL stream as request spans (kind="stage"),
        so trace-report and the jq runbook see one file format."""
        import time

        def sink(stage: str, start: float, elapsed_s: float, items: int) -> None:
            self.record(
                {
                    "kind": "stage",
                    "ts": time.time(),
                    "source": source,
                    "stage": stage,
                    "dur_ms": round(elapsed_s * 1e3, 4),
                    "items": items,
                }
            )

        return sink

    # ------------------------------------------------------------- writer
    def _drain(self) -> list[dict[str, Any]]:
        with self._lock:
            batch = list(self._buf)
            self._buf.clear()
        return batch

    def _write(self, batch: list[dict[str, Any]]) -> None:
        for record in batch:
            try:
                line = json.dumps(record, default=float) + "\n"
                # ONE write per line on an O_APPEND fd: the no-torn-lines
                # guarantee (SIGTERM drain, concurrent worker files).
                os.write(self._fd, line.encode())
            except (OSError, ValueError, TypeError):
                # A full disk / unserializable record costs that record,
                # never the writer thread or the serving path.
                logger.exception("trace writer failed to append a span")

    def _run(self) -> None:
        while not self._wake.wait(self._flush_interval_s):
            self._write(self._drain())
        self._write(self._drain())  # final drain on close

    # -------------------------------------------------------------- drain
    def close(self) -> None:
        """Flush everything buffered and stop the writer. Safe to call
        twice; records arriving after close are counted as dropped."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._writer.join(timeout=10)
        if self._writer.is_alive():
            # Writer stuck inside a blocked os.write (hung filesystem):
            # leave the fd to it. Closing here could recycle the fd
            # number under its pending writes — span lines appended into
            # whatever file next claims that number. One leaked fd on a
            # pathological path beats corrupting an unrelated file.
            logger.error(
                "trace writer did not drain within 10s (stalled "
                "filesystem?); leaving %s open", self.path,
            )
            return
        # The writer's final drain ran before it exited; catch any
        # in-flight stragglers that slipped in between, then release the fd.
        self._write(self._drain())
        try:
            os.close(self._fd)
        except OSError:
            pass
