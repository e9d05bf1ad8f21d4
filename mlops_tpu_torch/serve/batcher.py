"""Micro-batching queue: coalesce concurrent requests into one dispatch.

A port of the JAX package's ``serve/batcher.py``, unchanged in
behaviour, tracing spans included (a traced request's span gets the
``queue`` stamp at claim and the grouped dispatch's ``dispatch`` and
``device_fetch`` stamps; a solo call hands it to the engine). Under concurrent
load, one dispatch per small request leaves the card idle between short
programs; here requests that arrive together ride one grouped program
(``InferenceEngine.dispatch_group``) and each gets exactly the response
it would get alone.

Policy: only small requests (at most ``GROUP_ROW_BUCKET`` rows)
coalesce; larger ones go straight through. Two admission modes
(``serve.batch_mode``): "windowed" holds every group open for the fixed
window first; "continuous" (the default) admits pending requests into
in-flight group slots at dispatch boundaries (the in-flight round trip is
the coalescing window), and only an empty pipe waits, for a deadline
derived from the measured dispatch time.

Needs no torch: the engine it drives does the device work in executor
threads.
"""

from __future__ import annotations

import asyncio
from typing import Any

from mlops_tpu_torch.serve.wire import (
    GROUP_ROW_BUCKET,
    GROUP_SLOT_BUCKETS,
    DeadlineExceeded,
)

# A queued request: (records, future, absolute loop-clock deadline or
# None, trace span or None, routed tier or None).
_Entry = tuple[list[dict], asyncio.Future, "float | None", Any, "str | None"]


class MicroBatcher:
    """One drain loop and overlapped dispatches. One background task owns
    the queue and no task is ever cancelled (a cancel racing a mid-dispatch
    flush would strand futures). The loop waits out the window, claims up
    to ``max_group`` requests and starts the dispatch as its own task
    without awaiting it; ``max_inflight`` bounds the overlap.

    Each dispatch task has two phases: the dispatch (encode, device
    enqueue, the start of the packed output's copy to the host) under the
    in-flight bound, and the fetch (the wait for that copy) under the
    fetch ring, so the drain loop dispatches group N+1 while group N's
    bytes land. Lock order, outermost first: ``_inflight``, then
    ``_fetch_ring`` (a dispatch claims the ring before it releases its
    slot)."""

    def __init__(
        self,
        engine,
        executor,
        window_ms: float = 1.0,
        max_group: int = GROUP_SLOT_BUCKETS[-1],
        max_inflight: int = 4,
        fetch_inflight: int | None = None,
        batch_mode: str = "continuous",
        admit_fraction: float = 0.5,
        wire_responses: bool = False,
    ):
        if batch_mode not in ("continuous", "windowed"):
            raise ValueError(
                f"batch_mode must be 'continuous' or 'windowed', "
                f"got {batch_mode!r}"
            )
        self.engine = engine
        self._executor = executor
        self.window_s = window_ms / 1e3
        # A group never exceeds the largest slot bucket: past it the
        # engine has no warmed program to run.
        self.max_group = min(max_group, GROUP_SLOT_BUCKETS[-1])
        # "windowed": every group holds its window open for the full
        # window_s before claiming. "continuous": the drain loop claims the
        # in-flight slot first, then admits whatever is pending; while
        # other dispatches are in flight the admit wait is zero (their
        # round trips already gave co-travelers time to arrive), and an
        # empty pipe waits admit_fraction of the measured dispatch seconds,
        # capped by window_s. Group geometry never changes the
        # per-request math, so responses are the same in both modes.
        self.batch_mode = batch_mode
        self.admit_fraction = admit_fraction
        self._dispatch_ewma_s = 0.0  # event-loop confined, like every
        # mutable field below
        self._pending: list[_Entry] = []
        self._drain_task: asyncio.Task | None = None
        self._full = asyncio.Event()  # set when a full group is waiting
        self._inflight = asyncio.Semaphore(max_inflight)
        # The fetch ring: a dispatch releases its slot as soon as the
        # device work and the copy are enqueued and waits for the copy
        # under this second bound. Callers sharing the executor with other
        # work (the solo fast path, monitor fetches) size it so the sum
        # leaves headroom (serve/server.py); default: max_inflight.
        self._fetch_ring = asyncio.Semaphore(
            max_inflight if fetch_inflight is None else max(1, fetch_inflight)
        )
        self._dispatch_tasks: set[asyncio.Task] = set()  # strong refs
        self._last_enqueue = float("-inf")  # loop-clock time of the most
        # recent coalescable arrival (idle fast-path bookkeeping)
        self._solo_inflight = 0  # fast-path calls still in the executor:
        # they count against the idle condition, or a stalled engine would
        # pile un-cancellable executor work outside the claim-time purge
        # Wire mode: responses come back as JSON bytes encoded in the
        # executor thread, so the event loop never pays the dumps.
        self.wire_responses = bool(wire_responses)
        self._predict_solo = (
            getattr(engine, "predict_records_wire", None)
            if wire_responses
            else None
        ) or engine.predict_records

    @property
    def enabled(self) -> bool:
        return self.engine.supports_grouping and self.window_s > 0

    def _solo(self, records, tier, span=None):
        """The solo call for the executor; stub engines without the span
        or tier keyword only see it with tracing or tier routing on."""
        kwargs = {}
        if span is not None:
            kwargs["span"] = span
        if tier is not None:
            kwargs["tier"] = tier
        return lambda: self._predict_solo(records, **kwargs)

    async def predict(
        self,
        records: list[dict[str, Any]],
        deadline: float | None = None,
        tier: str | None = None,
        span: Any = None,
    ) -> dict[str, Any] | bytes:
        """Entry point for the request handler. ``deadline`` (absolute
        loop-clock time, from the request's ``x-request-deadline-ms``
        budget) rides with the queued entry: the claim-time purge completes
        an expired entry with ``DeadlineExceeded`` instead of dispatching
        it. ``tier`` (resolved upstream by ``engine.route_tier``; None is
        the engine's default tier) rides too: a group is one program, so
        only same-tier entries coalesce. ``span`` (tracing armed) rides
        the same way and gets the queue/dispatch/fetch stamps; None costs
        one branch per path."""
        loop = asyncio.get_running_loop()
        if not self.enabled or not (1 <= len(records) <= GROUP_ROW_BUCKET):
            return await loop.run_in_executor(
                self._executor, self._solo(records, tier, span)
            )

        # Idle fast path: with nothing queued, nothing in flight (grouped
        # or solo) and no arrival within the last window there are no
        # co-travelers to wait for, and holding the request would only
        # cost the window. Sustained load arrives within the window of the
        # previous request and still coalesces; a stalled solo call
        # (counter > 0) pushes new arrivals back onto the batcher, whose
        # claim-time purge and max_inflight bound the backlog.
        now = loop.time()
        idle = (
            not self._pending
            and not self._dispatch_tasks
            and self._solo_inflight == 0
            and (now - self._last_enqueue) > self.window_s
        )
        self._last_enqueue = now
        if idle:
            # The decrement is tied to executor completion, not caller
            # exit: a deadline-cancelled caller leaves the engine call
            # occupying its thread, and an early decrement would reopen
            # the fast path for the next victim.
            self._solo_inflight += 1
            fut = loop.run_in_executor(self._executor,
                                       self._solo(records, tier, span))

            def _done(f: asyncio.Future) -> None:
                self._solo_inflight -= 1
                if not f.cancelled():
                    f.exception()  # retrieve: the cancelled caller never will

            fut.add_done_callback(_done)
            # shield: a deadline-cancelled caller must not cancel the
            # executor future (that would fire _done while the thread
            # still runs).
            return await asyncio.shield(fut)

        future: asyncio.Future = loop.create_future()
        self._pending.append((records, future, deadline, span, tier))
        if len(self._pending) >= self.max_group:
            self._full.set()  # close the window early
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = asyncio.create_task(self._drain())
        return await future

    def _admit_deadline_s(self) -> float:
        """Continuous mode's empty-pipe admit wait: 0 while dispatches are
        in flight, else ``admit_fraction`` of the measured dispatch time,
        capped by the window (the full cap before any measurement)."""
        if self._dispatch_tasks:
            return 0.0
        if self._dispatch_ewma_s <= 0.0:
            return self.window_s
        return min(self.window_s, self.admit_fraction * self._dispatch_ewma_s)

    async def _wait_for_full(self, timeout: float) -> None:
        self._full.clear()
        try:
            await asyncio.wait_for(self._full.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    async def _drain(self) -> None:
        continuous = self.batch_mode == "continuous"
        while self._pending:
            if continuous:
                # Admission at the dispatch boundary: claim the in-flight
                # slot first, then give an empty pipe a short wait.
                await self._inflight.acquire()
                admit = self._admit_deadline_s()
                if admit > 0 and len(self._pending) < self.max_group:
                    await self._wait_for_full(admit)
            else:
                # Hold the window open for co-travelers (a full group
                # closes it early), then block only on the in-flight bound.
                if len(self._pending) < self.max_group:
                    await self._wait_for_full(self.window_s)
                await self._inflight.acquire()
            # Claim-time purge of dead entries: abandoned ones (the
            # caller's request deadline cancelled its future) are dropped,
            # so a recovering device serves live traffic first; expired
            # ones (budget spent in this queue) get DeadlineExceeded and
            # never cost a dispatch.
            now = asyncio.get_running_loop().time()
            live = []
            for entry in self._pending:
                _, future, entry_deadline, _, _ = entry
                if future.done():
                    continue
                if entry_deadline is not None and now >= entry_deadline:
                    future.set_exception(DeadlineExceeded())
                    continue
                live.append(entry)
            self._pending = live
            if not self._pending:
                self._inflight.release()
                continue
            # Same-tier claim: the head entry's tier and every queued
            # co-traveler on it (FIFO within the tier); other tiers stay
            # queued for the next iteration.
            head_tier = self._pending[0][4]
            batch: list[_Entry] = []
            rest: list[_Entry] = []
            for entry in self._pending:
                if len(batch) < self.max_group and entry[4] == head_tier:
                    batch.append(entry)
                else:
                    rest.append(entry)
            self._pending = rest
            task = asyncio.create_task(self._dispatch(batch, head_tier))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)
        # Exit with an empty queue: predict() sees the done task and starts
        # a fresh drain for the next arrival (both run on the event loop,
        # and the final emptiness check returns without awaiting).

    def _observe_dispatch_s(self, seconds: float) -> None:
        """Fold one measured dispatch-phase duration into the EWMA the
        continuous admit deadline reads."""
        if self._dispatch_ewma_s <= 0.0:
            self._dispatch_ewma_s = seconds
        else:
            self._dispatch_ewma_s = 0.8 * self._dispatch_ewma_s + 0.2 * seconds

    async def _dispatch(self, batch: list[_Entry], tier: str | None) -> None:
        loop = asyncio.get_running_loop()
        requests = [records for records, _, _, _, _ in batch]
        spans = [span for _, _, _, span, _ in batch if span is not None]
        for span in spans:
            # The queue stage ends at claim: the window wait and any wait
            # for the in-flight bound.
            span.stamp("queue")
        # The two-phase engine API when it has one: the dispatch holds the
        # in-flight slot, the blocking fetch rides the fetch ring. The
        # handle is local to this task, so responses never cross between
        # overlapped groups.
        dispatch = getattr(self.engine, "dispatch_group", None)
        fetch = (
            getattr(self.engine, "fetch_group_wire", None)
            if self.wire_responses
            else None
        ) or getattr(self.engine, "fetch_group", None)
        kwargs = {} if tier is None else {"tier": tier}
        released = False
        t_dispatch = loop.time()
        try:
            if dispatch is None or fetch is None:
                responses = await loop.run_in_executor(
                    self._executor,
                    lambda: self.engine.predict_group(requests, **kwargs),
                )
                # One-phase engines: the whole call stands in for the
                # dispatch time.
                self._observe_dispatch_s(loop.time() - t_dispatch)
            else:
                handle = await loop.run_in_executor(
                    self._executor, lambda: dispatch(requests, **kwargs)
                )
                self._observe_dispatch_s(loop.time() - t_dispatch)
                for span in spans:
                    # The engine encodes inside dispatch_group, so the
                    # dispatch stage covers encode and device enqueue.
                    span.stamp("dispatch")
                    span.entry = getattr(handle, "entry", None)
                # Claim the fetch ring before releasing the dispatch slot:
                # released first, a lagging fetch path would let dispatched
                # but unfetched handles pile up at the ring. This order
                # bounds them at max_inflight + fetch_inflight; ring
                # permits free on fetch completion, which never needs a
                # dispatch slot, so it cannot deadlock.
                async with self._fetch_ring:
                    self._inflight.release()
                    released = True
                    responses = await loop.run_in_executor(
                        self._executor, fetch, handle
                    )
                for span in spans:
                    span.stamp("device_fetch")
        # Whatever the dispatch raised (device error, encode bug) goes to
        # every waiter's future, where the handler answers 500.
        except Exception as err:
            for _, future, _, _, _ in batch:
                if not future.done():
                    future.set_exception(err)
        else:
            for (_, future, _, _, _), response in zip(batch, responses):
                if not future.done():
                    future.set_result(response)
        finally:
            if not released:
                self._inflight.release()
