"""Staged streaming executor: overlap host I/O, encode, host -> device
copies, device compute and output across chunks.

A copy of the JAX package's ``data/pipeline_exec.py``. The bulk paths
(``data/stream.py score_csv_stream``, ``parallel/bulk.py
score_dataset``) are chunked loops whose per-chunk work splits into
independent stages (read and parse, encode, transfer, compute, fetch,
write). ``run_pipeline(source, stages, sink, depth)`` wires

    source ──q──> stage 1 ──q──> ... ──q──> stage S ──q──> sink

with one thread per producer (the source iterator and each ``Stage.fn``
run on their own threads; the ``sink`` runs on the caller's thread).
Every link is a ``queue.Queue(maxsize=depth)``:

- **Backpressure**: a stage that races ahead blocks on its full output
  queue, so in-flight work is bounded at a few chunks whatever the size
  of the dataset.
- **Order**: single-threaded stages and FIFO queues keep chunk order end
  to end, so a deterministic stage graph gives the same output at any
  depth. ``depth <= 1`` runs a plain serial loop on the caller's thread.
- **Batch stages** (``Stage(batch_max=k)``): the worker takes whatever
  is immediately available (1..k items) and passes the list to ``fn``,
  which returns one output per input; ``fn`` must not depend on the
  grouping.
- **Failures**: an exception in any stage, the source or the sink stops
  the pipeline: the failing worker forwards a failure marker downstream
  and keeps draining its input so no producer stays blocked on a full
  queue. The caller joins every thread, then re-raises the original
  exception.

Per-stage busy time (``StageClock``) comes back in ``PipelineStats``:
occupancies sum to about 1.0 when serial and exceed it when the stages
overlap, and the largest names the bottleneck stage. All cross-thread
state rides the internally locked queues and one ``threading.Event``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable

# How long the caller waits for workers to drain after the last sentinel
# before declaring the executor wedged. Drain is bounded by the in-flight
# item count, not the dataset.
_JOIN_TIMEOUT_S = 60.0


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


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: ``fn(item) -> item`` on its own worker thread.

    ``batch_max > 1`` switches ``fn`` to list-in/list-out over whatever
    items are immediately available (at most ``batch_max``).
    ``queue_depth`` overrides the bound of this stage's input queue
    (default: the pipeline's ``depth``): a batched fetch stage keeps a
    deep window that way without deepening every other queue.
    """

    name: str
    fn: Callable[[Any], Any]
    batch_max: int = 1
    queue_depth: int | None = None


@dataclasses.dataclass
class PipelineStats:
    """Timing of one pipeline run."""

    depth: int
    wall_s: float
    items: int  # items the sink consumed
    stages: dict[str, dict[str, float]]  # name -> busy_s / items / occupancy

    def as_dict(self) -> dict[str, Any]:
        return {
            "depth": self.depth,
            "wall_s": round(self.wall_s, 4),
            "items": self.items,
            "stages": self.stages,
        }


class _Failure:
    """A stage's exception, traveling the queues in place of an item."""

    __slots__ = ("stage", "exc")

    def __init__(self, stage: str, exc: BaseException):
        self.stage = stage
        self.exc = exc


_DONE = object()  # end-of-stream sentinel; exactly one per producer


def run_pipeline(
    source: Iterable[Any],
    stages: list[Stage],
    sink: Callable[[Any], None],
    depth: int = 4,
    source_name: str = "read",
    sink_name: str = "write",
    stage_sink: Callable | None = None,
) -> PipelineStats:
    """Stream ``source`` through ``stages`` into ``sink``. Returns
    per-stage timing; re-raises the original exception if any stage
    fails. ``stage_sink`` additionally receives every completed stage
    execution (``StageClock``)."""
    depth = max(1, int(depth))
    clock = StageClock(sink=stage_sink)
    start = time.perf_counter()
    if depth <= 1:
        items = _run_serial(source, stages, sink, clock, source_name, sink_name)
    else:
        items = _run_threaded(
            source, stages, sink, depth, clock, source_name, sink_name
        )
    wall = time.perf_counter() - start
    return PipelineStats(
        depth=depth, wall_s=wall, items=items, stages=clock.report(wall)
    )


def _run_serial(source, stages, sink, clock, source_name, sink_name) -> int:
    """depth <= 1: the serial loop on the caller's thread, instrumented."""
    iterator = iter(source)
    count = 0
    while True:
        with clock.stage(source_name):
            item = next(iterator, _DONE)
        if item is _DONE:
            break
        for stage in stages:
            with clock.stage(stage.name):
                if stage.batch_max > 1:
                    item = stage.fn([item])[0]
                else:
                    item = stage.fn(item)
        with clock.stage(sink_name):
            sink(item)
        count += 1
    return count


def _run_threaded(
    source, stages, sink, depth, clock, source_name, sink_name
) -> int:
    stop = threading.Event()
    links = [
        queue.Queue(maxsize=stage.queue_depth or depth) for stage in stages
    ] + [queue.Queue(maxsize=depth)]

    threads = [
        threading.Thread(
            target=_pump_source,
            args=(source, links[0], stop, clock, source_name),
            name=f"pipeline-{source_name}",
            daemon=True,
        )
    ]
    for i, stage in enumerate(stages):
        threads.append(
            threading.Thread(
                target=_run_stage,
                args=(stage, links[i], links[i + 1], stop, clock),
                name=f"pipeline-{stage.name}",
                daemon=True,
            )
        )
    for t in threads:
        t.start()

    failures: list[_Failure] = []
    count = 0
    final = links[-1]
    try:
        # The sink loop consumes to _DONE unconditionally, even after a
        # failure, so upstream workers can always finish their drain.
        while True:
            item = final.get()
            if item is _DONE:
                break
            if isinstance(item, _Failure):
                stop.set()
                failures.append(item)
                continue
            if failures or stop.is_set():
                continue  # draining after a sink-side failure
            try:
                with clock.stage(sink_name):
                    sink(item)
                count += 1
            # Captured, forwarded, and re-raised after the drain.
            except BaseException as exc:
                stop.set()
                failures.append(_Failure(sink_name, exc))
    finally:
        for t in threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
        wedged = [t.name for t in threads if t.is_alive()]
        if wedged:
            # A worker failed to drain: never return with live threads.
            raise RuntimeError(
                f"pipeline workers failed to drain: {wedged}"
            ) from (failures[0].exc if failures else None)
    if failures:
        raise failures[0].exc
    return count


def _pump_source(source, out, stop, clock, name) -> None:
    try:
        iterator = iter(source)
        while not stop.is_set():
            with clock.stage(name):
                item = next(iterator, _DONE)
            if item is _DONE:
                break
            out.put(item)
    # Captured as a _Failure and re-raised by the caller.
    except BaseException as exc:
        stop.set()
        out.put(_Failure(name, exc))
    finally:
        out.put(_DONE)


def _run_stage(stage: Stage, inq, outq, stop, clock) -> None:
    draining = False
    try:
        while True:
            item = inq.get()
            if item is _DONE:
                break
            if isinstance(item, _Failure):
                stop.set()
                outq.put(item)
                draining = True
                continue
            if draining or stop.is_set():
                continue
            try:
                if stage.batch_max > 1:
                    if _run_batch(stage, item, inq, outq, stop, clock):
                        break
                else:
                    with clock.stage(stage.name):
                        out = stage.fn(item)
                    outq.put(out)
            # Captured as a _Failure and re-raised by the caller.
            except BaseException as exc:
                stop.set()
                outq.put(_Failure(stage.name, exc))
                draining = True
    finally:
        outq.put(_DONE)


def _run_batch(stage: Stage, first, inq, outq, stop, clock) -> bool:
    """Gather up to ``batch_max`` immediately available items, run ``fn``
    over the list, forward each result. Handles its own ``fn`` failure:
    the gather may have swallowed the _DONE sentinel, and an exception
    escaping past that would leave the worker blocked on an empty queue.
    Returns True when _DONE was swallowed (the stage must exit)."""
    batch = [first]
    saw_done = False
    pending: _Failure | None = None
    while len(batch) < stage.batch_max:
        try:
            extra = inq.get_nowait()
        except queue.Empty:
            break
        if extra is _DONE:
            saw_done = True
            break
        if isinstance(extra, _Failure):
            pending = extra
            break
        batch.append(extra)
    try:
        with clock.stage(stage.name, items=len(batch)):
            outs = stage.fn(batch)
    # Captured as a _Failure and re-raised by the caller.
    except BaseException as exc:
        stop.set()
        outq.put(_Failure(stage.name, exc))
        outs = []
    for out in outs:
        outq.put(out)
    if pending is not None:
        stop.set()
        outq.put(pending)
        # Keep draining on the normal loop; the failure is forwarded.
    return saw_done
