"""Shared-memory IPC of the ring plane: N HTTP front ends -> one engine.

The port's copy of the JAX package's ``serve/ipc.py`` for one tenant and
one engine replica (the replica set and tenancy are ROADMAP A4). Front-end
processes validate and encode requests and write the feature arrays
straight into fixed-slot slabs of one shared memory segment; the engine
process scores them (coalescing concurrent small requests into one
grouped dispatch, as the in-process micro-batcher does) and writes the
raw response arrays back into the same slot. Only 8-byte descriptors
cross a queue: the arrays are never pickled or piped.

Topology and ownership:

- One anonymous ``mmap`` (``MAP_SHARED``) built by the supervisor before
  it forks anything; every process sees the same pages by inheritance.
- Every front end owns a fixed partition of the slots: claim and release
  are confined to its event loop. The only cross-process lock a front end
  takes is the submission queue's (producers only); the completion
  queue's belongs to the engine's threads alone. Both consumers are
  lock-free and fenced by a counted doorbell instead: the ``eventfd``
  value is the number of entries published, and a consumer consumes only
  what a drained doorbell credited. A ``kill -9`` on either side
  therefore never orphans a lock the other side needs.
- Two slot classes per worker: small slabs of ``GROUP_ROW_BUCKET`` rows
  (the coalescable class) and large slabs of ``max_batch`` rows (solo
  dispatches; a small request may overflow into a free large slab, never
  the reverse). An exhausted class is the shed signal: 503 with
  Retry-After, never an unbounded queue.
- Per-slot generations: a front end bumps the slot's generation at
  submit, the engine stamps the response with it, and a completion with
  a stale generation is dropped, so a respawned front end is never handed
  a dead request's answer.
- The engine incarnation word: a respawned engine bumps it, recovers the
  completion lock its predecessor may have died holding, seeds its
  monitor totals from the shared aggregate and carries the dead
  incarnation's lifecycle counters as bases (exported counters stay
  monotone) and replays every busy slot whose completion never came
  (``RingService.reattach``). The slabs hold the full encoded input and
  the packed programs are pure, so a replayed answer is bit-identical.
  Completions stamped by a dead incarnation are dropped on arrival.

Lock discipline: locks guard index arithmetic only; slab reads and
writes happen outside every lock, on slots exclusively owned between
claim and release. Outermost first: ``RingService._inflight`` (the
dispatch bound, taken by the collector and released by the pool thread
that finishes the job), then the leaves ``RequestRing._submit_lock``,
``RequestRing._complete_lock`` and ``RingService._mon_lock``.

Nothing here imports torch: front ends import this module, and the
engine side reaches the device only through the engine it is given.
"""

from __future__ import annotations

import concurrent.futures
import logging
import mmap
import multiprocessing
import os
import select
import threading
import time
from typing import Any, Callable

import numpy as np

from mlops_tpu_torch import faults
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.metrics import (
    ENG_EXPIRED,
    ENG_INCARNATION,
    ENG_REPLAYED,
    ENG_ROWS_DISPATCHED,
    ENG_ROWS_LOST,
    LATENCY_BUCKETS,
    LIFE_AUC_DELTA,
    LIFE_BREAKER_OPEN,
    LIFE_BREAKER_TRIPS,
    LIFE_GENERATION,
    LIFE_HAS,
    LIFE_HAS_DELTA,
    LIFE_OUTCOMES,
    LIFE_RESERVOIR,
    LIFE_TRIGGERS,
    MON_BATCHES,
    MON_FETCHED_AT,
    MON_FETCHES,
    MON_HAS,
    MON_OUTLIERS,
    MON_ROWS,
    RING_STATUSES,
    ROUTES,
)
from mlops_tpu_torch.serve.tierroute import TIERS
from mlops_tpu_torch.serve.wire import (
    GROUP_ROW_BUCKET,
    GROUP_SLOT_BUCKETS,
    RESP_ERROR,
    RESP_EXPIRED,
    RESP_OK,
)

logger = logging.getLogger("mlops_tpu_torch.serve")

SMALL, LARGE = 0, 1
_STATUS_IDX = {s: i for i, s in enumerate(RING_STATUSES)}
_ROUTE_IDX = {r: i for i, r in enumerate(ROUTES)}
_TIER_IDX = {t: i for i, t in enumerate(TIERS)}
# The engine's dispatches per program label, mirrored into a fixed table:
# rows are assigned in first-seen order and never move.
DISPATCH_ROWS = 128
DISPATCH_KEY_BYTES = 32
# Control words: ready, draining, and how many tiers the engine holds.
CTL_READY, CTL_DRAINING, CTL_TIERS = range(3)


class Doorbell:
    """A cross-process wakeup on ``os.eventfd``, made before fork and
    shared by inheritance. The value is a count: ``ring(n)`` publishes n
    entries and ``drain()`` returns the count, the consumer's credit. The
    eventfd write/read pair synchronizes through the kernel, so every
    store the producer made before ringing is visible after draining: the
    fence that keeps the consumers lock-free. ``ring`` never blocks and
    tolerates a closed peer."""

    def __init__(self) -> None:
        self._fd = os.eventfd(0, os.EFD_NONBLOCK)

    def fileno(self) -> int:
        return self._fd

    def ring(self, count: int = 1) -> None:
        try:
            os.write(self._fd, count.to_bytes(8, "little"))
        except OSError:
            pass  # a closed peer is gone; nothing waits on it

    def wait(self, timeout_s: float | None = None) -> int:
        """Block until the doorbell rings or the timeout passes; the
        drained count (0 on timeout)."""
        ready, _, _ = select.select([self._fd], [], [], timeout_s)
        return self.drain() if ready else 0

    def drain(self) -> int:
        try:
            return int.from_bytes(os.read(self._fd, 8), "little")
        except (BlockingIOError, OSError):
            return 0

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


def _pack(slot: int, gen: int) -> int:
    return (int(gen) & 0xFFFFFFFF) << 32 | (int(slot) & 0xFFFFFFFF)


def _unpack(entry: int) -> tuple[int, int]:
    return int(entry) & 0xFFFFFFFF, (int(entry) >> 32) & 0xFFFFFFFF


class RequestRing:
    """The shared segment, its typed views and the descriptor queues.
    Build once, before forking; multi-word races are excluded by
    ownership (a slot belongs to one side between claim and completion,
    each stats cell has one writer)."""

    def __init__(self, workers: int, slots_small: int, slots_large: int,
                 large_rows: int, small_rows: int = GROUP_ROW_BUCKET) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.workers = workers
        self.slots_small = slots_small
        self.slots_large = slots_large
        self.small_rows = small_rows
        self.large_rows = max(large_rows, small_rows)
        self.n_small = workers * slots_small
        self.n_large = workers * slots_large
        self.n_slots = self.n_small + self.n_large
        C, N = SCHEMA.num_categorical, SCHEMA.num_numeric
        self.n_features = D = C + N
        u64, u32, f64 = np.dtype(np.uint64), np.dtype(np.uint32), np.dtype(np.float64)
        plan: list[tuple[str, np.dtype, tuple[int, ...]]] = [
            ("ctl", u64, (4,)),
            # The submission queue (front ends -> the engine's collector).
            ("sub_entries", u64, (self.n_slots,)),
            ("sub_head", u64, (1,)),
            ("sub_tail", u64, (1,)),
            # One completion queue per worker (engine -> that front end);
            # a worker never has more slots in flight than it owns.
            ("comp_entries", u64, (workers, slots_small + slots_large)),
            ("comp_head", u64, (workers,)),
            ("comp_tail", u64, (workers,)),
            # Slot headers. slot_busy marks submitted-but-unreleased slots
            # in shared memory, so a respawned front end quarantines them
            # (the engine may still write their slabs) and a respawned
            # engine replays them. slot_slo is the routed SLO class (after
            # brownout demotion): the dispatch and a replay both resolve
            # the same tier from it. slot_deadline is the absolute
            # CLOCK_MONOTONIC deadline (0: none), which the engine checks
            # before dispatching.
            ("slot_gen", u32, (self.n_slots,)),
            ("slot_n", u32, (self.n_slots,)),
            ("slot_busy", u32, (self.n_slots,)),
            ("slot_slo", u32, (self.n_slots,)),
            ("slot_deadline", f64, (self.n_slots,)),
            ("resp_gen", u32, (self.n_slots,)),
            ("resp_status", u32, (self.n_slots,)),
            ("resp_incarnation", u32, (self.n_slots,)),
            # Request slabs (front end writes, engine reads).
            ("small_cat", np.dtype(np.int32), (self.n_small, small_rows, C)),
            ("small_num", np.dtype(np.float32), (self.n_small, small_rows, N)),
            ("large_cat", np.dtype(np.int32), (self.n_large, self.large_rows, C)),
            ("large_num", np.dtype(np.float32), (self.n_large, self.large_rows, N)),
            # Response slabs (engine writes, front end reads): f64
            # predictions ‖ outliers ‖ drift, the raw-fetch arrays the
            # single-process plane encodes, so the bytes are the same.
            ("small_resp", f64, (self.n_small, 2 * small_rows + D)),
            ("large_resp", f64, (self.n_large, 2 * self.large_rows + D)),
            # Per-worker serving stats (single writer: that worker).
            ("req_counts", u64, (workers, len(ROUTES), len(RING_STATUSES) + 1)),
            ("lat_counts", u64, (workers, len(LATENCY_BUCKETS))),
            ("lat_sum_ms", f64, (workers,)),
            ("lat_n", u64, (workers,)),
            ("shed", u64, (workers, 2)),
            ("inflight", u64, (workers, 2)),
            ("expired", u64, (workers,)),
            # Requests admitted while the engine is down, holding a slot
            # for the respawned engine's replay (a gauge), and sheds of a
            # full partition during such an outage.
            ("parked", u64, (workers,)),
            ("brownout_shed", u64, (workers,)),
            ("tier_demote", u64, (workers,)),
            ("brownout_demote", u64, (workers,)),
            # Engine-process writers (under RingService._mon_lock).
            ("tier_counts", f64, (len(TIERS),)),
            ("mon_vals", f64, (8,)),
            ("mon_drift_last", f64, (D,)),
            ("mon_drift_mean", f64, (D,)),
            # Unrounded cumulative sums: a respawned engine seeds its
            # exact host totals from them.
            ("mon_drift_sum", f64, (D,)),
            ("eng_vals", f64, (8,)),
            ("disp_keys", np.dtype(np.uint8), (DISPATCH_ROWS, DISPATCH_KEY_BYTES)),
            ("disp_vals", f64, (DISPATCH_ROWS,)),
            ("kernel_launches", f64, (1,)),
            # The engine-side lifecycle loop's gauges (the telemetry
            # thread writes them; see serve/metrics.py LIFE_*), so any
            # front end renders them.
            ("life_vals", f64, (8,)),
            ("life_promos", f64, (len(LIFE_OUTCOMES),)),
        ]
        offset, offsets = 0, {}
        for name, dtype, shape in plan:
            offset = (offset + 63) & ~63  # 64-byte align every region
            offsets[name] = offset
            offset += dtype.itemsize * int(np.prod(shape))
        self._mm = mmap.mmap(-1, offset)  # anonymous, MAP_SHARED
        for name, dtype, shape in plan:
            view = np.frombuffer(self._mm, dtype=dtype, count=int(np.prod(shape)),
                                 offset=offsets[name]).reshape(shape)
            setattr(self, name, view)
        ctx = multiprocessing.get_context("fork")
        self._submit_lock = ctx.Lock()  # producers (front ends) only
        self._complete_lock = ctx.Lock()  # the engine's threads only
        self.engine_doorbell = Doorbell()
        self.worker_doorbells = [Doorbell() for _ in range(workers)]

    # ------------------------------------------------------ control words
    @property
    def engine_ready(self) -> bool:
        return bool(self.ctl[CTL_READY])

    def set_ready(self, ready: bool) -> None:
        self.ctl[CTL_READY] = 1 if ready else 0

    @property
    def draining(self) -> bool:
        return bool(self.ctl[CTL_DRAINING])

    def set_draining(self) -> None:
        self.ctl[CTL_DRAINING] = 1

    @property
    def engine_tiers(self) -> int:
        """How many tiers the engine dispatches per request (0 before the
        first engine is up)."""
        return int(self.ctl[CTL_TIERS])

    # ----------------------------------------------------- slot geometry
    def worker_slots(self, worker: int) -> tuple[range, range]:
        """(small slot ids, large slot ids) owned by ``worker``."""
        s0 = worker * self.slots_small
        l0 = self.n_small + worker * self.slots_large
        return range(s0, s0 + self.slots_small), range(l0, l0 + self.slots_large)

    def slot_class(self, slot: int) -> int:
        return SMALL if slot < self.n_small else LARGE

    def slot_owner(self, slot: int) -> int:
        if slot < self.n_small:
            return slot // self.slots_small
        return (slot - self.n_small) // self.slots_large

    def request_views(self, slot: int) -> tuple[np.ndarray, np.ndarray]:
        """The slot's full (cat int32[rows, C], num f32[rows, N]) slabs."""
        if slot < self.n_small:
            return self.small_cat[slot], self.small_num[slot]
        i = slot - self.n_small
        return self.large_cat[i], self.large_num[i]

    def response_views(self, slot: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(predictions, outliers, drift) f64 views of the response slab,
        sliced to the slot's row count."""
        n = int(self.slot_n[slot])
        if slot < self.n_small:
            resp, rows = self.small_resp[slot], self.small_rows
        else:
            resp, rows = self.large_resp[slot - self.n_small], self.large_rows
        return resp[:n], resp[rows:rows + n], resp[2 * rows:]

    # ------------------------------------------------------- descriptors
    def submit(self, slot: int, gen: int) -> None:
        """Front-end side: enqueue a filled slot. The lock (producers
        only) orders the slab stores before the head bump; the doorbell
        rings outside it with one unit of credit."""
        with self._submit_lock:
            head = int(self.sub_head[0])
            self.sub_entries[head % self.n_slots] = _pack(slot, gen)
            self.sub_head[0] = head + 1
        self.engine_doorbell.ring()

    def pop_submissions(self, limit: int | None = None) -> list[tuple[int, int]]:
        """Engine side, the one consumer, lock-free: at most ``limit``
        entries (the doorbell credit), so an entry is consumed only after
        a doorbell rung after its publication was drained."""
        head, tail = int(self.sub_head[0]), int(self.sub_tail[0])
        if limit is not None:
            head = min(head, tail + limit)
        out = [_unpack(int(self.sub_entries[i % self.n_slots])) for i in range(tail, head)]
        self.sub_tail[0] = head if head > tail else tail
        return out

    def pending_submissions(self) -> set[int]:
        """Slots with a descriptor queued but not popped: the re-attach
        replay leaves them to the collector."""
        head, tail = int(self.sub_head[0]), int(self.sub_tail[0])
        return {_unpack(int(self.sub_entries[i % self.n_slots]))[0]
                for i in range(tail, head)}

    def recover_engine_lock(self) -> None:
        """A respawned engine frees the completion lock its predecessor
        may have died holding. Safe because only engine processes take
        it, the supervisor runs one at a time, and this runs before the
        new engine starts a thread: a failed try-acquire can only be an
        orphaned hold."""
        if self._complete_lock.acquire(block=False):
            self._complete_lock.release()
            return
        self._complete_lock.release()
        logger.warning("recovered the completion lock of a dead engine")

    def push_completion(self, slot: int, gen: int) -> None:
        """Engine side: hand a finished slot back to its owner's queue."""
        worker = self.slot_owner(slot)
        cap = self.comp_entries.shape[1]
        with self._complete_lock:
            head = int(self.comp_head[worker])
            self.comp_entries[worker, head % cap] = _pack(slot, gen)
            self.comp_head[worker] = head + 1

    def pop_completions(self, worker: int, limit: int | None = None) -> list[tuple[int, int]]:
        """Front-end side, lock-free and credit-fenced like
        ``pop_submissions``."""
        cap = self.comp_entries.shape[1]
        head, tail = int(self.comp_head[worker]), int(self.comp_tail[worker])
        if limit is not None:
            head = min(head, tail + limit)
        out = [_unpack(int(self.comp_entries[worker, i % cap])) for i in range(tail, head)]
        if head > tail:
            self.comp_tail[worker] = head
        return out

    # ---------------------------------------------- engine-written tables
    def write_monitor(self, snapshot: dict[str, Any]) -> None:
        """Install the engine's ``monitor_snapshot`` for the front ends'
        renders. Field-at-a-time f64 stores; a scrape racing this write
        may see a mix, which gauges tolerate."""
        row = self.mon_vals
        row[MON_ROWS] = float(snapshot["rows"])
        row[MON_OUTLIERS] = float(snapshot["outliers"])
        row[MON_BATCHES] = float(snapshot["batches"])
        self.mon_drift_last[:] = list(snapshot["drift_last"].values())
        self.mon_drift_mean[:] = list(snapshot["drift_mean"].values())
        self.mon_drift_sum[:] = snapshot["drift_sum"]
        row[MON_FETCHES] += 1
        row[MON_FETCHED_AT] = time.monotonic()
        row[MON_HAS] = 1.0

    def write_lifecycle(self, snapshot: dict[str, Any]) -> None:
        """Install the lifecycle controller's ``metrics_snapshot`` for the
        front ends' renders (engine-process single writer; the same
        tearing contract as ``write_monitor``)."""
        if not snapshot:
            return
        row = self.life_vals
        row[LIFE_GENERATION] = float(snapshot["generation"])
        row[LIFE_TRIGGERS] = float(snapshot["drift_triggers"])
        delta = snapshot.get("shadow_auc_delta")
        row[LIFE_AUC_DELTA] = 0.0 if delta is None else float(delta)
        row[LIFE_HAS_DELTA] = 0.0 if delta is None else 1.0
        row[LIFE_RESERVOIR] = float(snapshot.get("reservoir_rows") or 0)
        row[LIFE_BREAKER_OPEN] = 1.0 if snapshot.get("breaker_open") else 0.0
        row[LIFE_BREAKER_TRIPS] = float(snapshot.get("breaker_trips", 0))
        promotions = snapshot.get("promotions", {})
        for i, outcome in enumerate(LIFE_OUTCOMES):
            self.life_promos[i] = float(promotions.get(outcome, 0))
        row[LIFE_HAS] = 1.0

    def dispatch_counts(self) -> dict[str, int]:
        """The engine's mirrored dispatches per program label."""
        out = {}
        for key, count in zip(self.disp_keys, self.disp_vals):
            label = bytes(key).rstrip(b"\0").decode()
            if label:
                out[label] = int(count)
        return out

    def close(self) -> None:
        for bell in (self.engine_doorbell, *self.worker_doorbells):
            bell.close()


class ShmWorkerMetrics:
    """The request recorder of one front end, writing its row of the
    shared stats: single writer (that worker's event loop), so no lock;
    readers see monotone counters."""

    def __init__(self, ring: RequestRing, worker: int) -> None:
        self._ring = ring
        self._worker = worker

    def observe_request(self, route: str, status: int, latency_ms: float) -> None:
        ring, w = self._ring, self._worker
        r = _ROUTE_IDX.get(route, _ROUTE_IDX["<other>"])
        ring.req_counts[w, r, _STATUS_IDX.get(status, len(RING_STATUSES))] += 1
        ring.lat_sum_ms[w] += latency_ms
        ring.lat_n[w] += 1
        for i, edge in enumerate(LATENCY_BUCKETS):
            if latency_ms <= edge:
                ring.lat_counts[w, i] += 1
                break

    def count_deadline_expired(self) -> None:
        """A request answered 504 before its slot was submitted."""
        self._ring.expired[self._worker] += 1


class RingClient:
    """One front end's view of the ring: slot claim, submit and release,
    and the completion doorbell. Everything here is confined to the
    owning worker's event loop."""

    def __init__(self, ring: RequestRing, worker: int) -> None:
        self.ring = ring
        self.worker = worker
        small, large = ring.worker_slots(worker)
        # Restart-safe: a slot the dead incarnation of this worker
        # submitted and never released may still see an engine write, so
        # it is quarantined until the engine's completion for it arrives
        # (the engine answers every accepted descriptor). Bumping every
        # generation makes completions addressed to the dead incarnation
        # stale on arrival.
        self._free: tuple[list[int], list[int]] = ([], [])
        self._quarantined: set[int] = set()
        self.partition_slots = len(small) + len(large)
        ring.inflight[worker, :] = 0
        for slot in (*small, *large):
            ring.slot_gen[slot] += 1
            if int(ring.slot_busy[slot]):
                self._quarantined.add(slot)
                ring.inflight[worker, ring.slot_class(slot)] += 1
            else:
                self._free[ring.slot_class(slot)].append(slot)
        # The dead incarnation's parked requests died with its
        # connections.
        ring.parked[worker] = 0
        # Completion credit, seeded with the entries already queued,
        # whose doorbell a dead incarnation may have drained.
        self._credit = int(ring.comp_head[worker]) - int(ring.comp_tail[worker])
        # slot -> (generation, future). A future that gave up waiting (a
        # deadline) leaves a zombie: the slot is reused only once the
        # engine's completion arrives.
        self._pending: dict[int, tuple[int, Any]] = {}

    def claim(self, n_rows: int, slo: int = 0) -> int | None:
        """A free slot whose slab fits ``n_rows``, or None (shed). The
        routed SLO class rides the slot header."""
        small_free, large_free = self._free
        if n_rows <= self.ring.small_rows and small_free:
            slot = small_free.pop()
        elif large_free:
            slot = large_free.pop()
        else:
            return None
        self.ring.slot_slo[slot] = slo
        self.ring.inflight[self.worker, self.ring.slot_class(slot)] += 1
        return slot

    def count_shed(self, n_rows: int) -> None:
        cls = SMALL if n_rows <= self.ring.small_rows else LARGE
        self.ring.shed[self.worker, cls] += 1

    def pressure(self) -> float:
        """Occupied fraction of this worker's partition (1.0: the next
        claim sheds); quarantined slots count as occupied."""
        free = len(self._free[SMALL]) + len(self._free[LARGE])
        return 1.0 - free / self.partition_slots

    def count_demotion(self, brownout: bool = False) -> None:
        self.ring.tier_demote[self.worker] += 1
        if brownout:
            self.ring.brownout_demote[self.worker] += 1

    def submit(self, slot: int, cat: np.ndarray, num: np.ndarray,
               deadline: float | None = None):
        """Write the encoded arrays into the slot's slab and enqueue it;
        the asyncio future the completion resolves with the engine's
        status. ``deadline`` is absolute ``time.monotonic`` seconds."""
        import asyncio

        n = cat.shape[0]
        ring = self.ring
        slab_cat, slab_num = ring.request_views(slot)
        slab_cat[:n] = cat
        slab_num[:n] = num
        ring.slot_n[slot] = n
        ring.slot_deadline[slot] = deadline if deadline is not None else 0.0
        gen = (int(ring.slot_gen[slot]) + 1) & 0xFFFFFFFF
        ring.slot_gen[slot] = gen
        # Busy before the descriptor: a worker dying past here leaves the
        # slot for the next incarnation's quarantine.
        ring.slot_busy[slot] = 1
        future = asyncio.get_running_loop().create_future()
        self._pending[slot] = (gen, future)
        ring.submit(slot, gen)
        return future

    def _free_slot(self, slot: int) -> None:
        self.ring.slot_busy[slot] = 0
        cls = self.ring.slot_class(slot)
        self._free[cls].append(slot)
        self.ring.inflight[self.worker, cls] -= 1

    def release(self, slot: int) -> None:
        """Return a slot whose response was consumed (or that was never
        submitted) to the free list."""
        self._pending.pop(slot, None)
        self._free_slot(slot)

    def abandon(self, slot: int) -> None:
        """The deadline or error path after a submit: reuse the slot now
        only if its answer already landed; otherwise it stays a zombie
        that the completion releases. A slot already released by that
        path (the completion landed while ``wait_for`` was cancelling)
        is left alone: releasing twice would give one slab to two
        requests."""
        entry = self._pending.get(slot)
        if entry is not None and entry[1].done() and not entry[1].cancelled():
            self.release(slot)

    def response_arrays(self, slot: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.ring.response_views(slot)

    def on_doorbell(self) -> None:
        """Event-loop reader callback: drain the completions the doorbell
        credited, resolve live futures, release zombies, and drain the
        quarantine (the engine answering a slot proves its slab is
        quiescent). Credit beyond what pops is surplus and dropped:
        entries always arrive with their own ring."""
        ring = self.ring
        credit = self._credit + ring.worker_doorbells[self.worker].drain()
        self._credit = 0
        for slot, gen in ring.pop_completions(self.worker, limit=credit):
            entry = self._pending.get(slot)
            if entry is None or entry[0] != gen:
                # Addressed to a dead incarnation of this worker.
                if slot in self._quarantined:
                    self._quarantined.discard(slot)
                    self._free_slot(slot)
                continue
            future = entry[1]
            if future.cancelled():
                self.release(slot)  # a zombie: its waiter gave up
            elif future.done():
                # A duplicate across an engine respawn (the replay
                # re-answered a slot whose first completion was already
                # queued): the awaiting handler owns the release.
                continue
            elif int(ring.resp_incarnation[slot]) != int(ring.eng_vals[ENG_INCARNATION]):
                # Produced by a dead engine incarnation: nothing it left
                # is trusted; the replay re-answers, or the deadline turns
                # the wait into a 504 and the zombie path reclaims.
                logger.info("dropping slot %d's completion from dead engine "
                            "incarnation %d", slot, int(ring.resp_incarnation[slot]))
            elif int(ring.resp_gen[slot]) != gen:
                logger.error("slot %d completed gen %d but its slab carries gen %d",
                             slot, gen, int(ring.resp_gen[slot]))
            else:
                future.set_result(int(ring.resp_status[slot]))

    def pending_count(self) -> int:
        return len(self._pending)


class RingService:
    """The engine-process half: collect submitted slots, coalesce small
    requests into grouped dispatches through the engine's two-phase API
    (``dispatch_group_arrays`` / ``fetch_group_raw``, the path the
    micro-batcher takes), run jobs on a thread pool so dispatches
    overlap, write raw responses into the slabs and ring the owners'
    doorbells. It answers every accepted descriptor (scored, failed or
    expired), and never waits on front-end state. With a lifecycle
    controller attached (``attach_lifecycle``), its telemetry thread also
    mirrors the controller's gauges into the ring's lifecycle row."""

    def __init__(self, engine: Any, ring: RequestRing, max_group: int = 64,
                 max_inflight: int = 4, threads: int = 8,
                 monitor_fetch_every_s: float = 2.0,
                 monitor_fetch_every_requests: int = 512,
                 kernel_launches: Callable[[], int] = lambda: 0) -> None:
        self.engine = engine
        self.ring = ring
        self.max_group = max(2, min(max_group, GROUP_SLOT_BUCKETS[-1]))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, threads), thread_name_prefix="ring"
        )
        self._inflight = threading.BoundedSemaphore(max_inflight)
        self._mon_lock = threading.Lock()
        self._stop = threading.Event()
        self._collector: threading.Thread | None = None
        self._telemetry: threading.Thread | None = None
        self._mon_period = monitor_fetch_every_s
        self._mon_every = monitor_fetch_every_requests
        self._accumulating = hasattr(engine, "monitor_snapshot")
        self._kernel_launches = kernel_launches
        # Respawn bases of the mirrored counters (set by ``reattach``): a
        # respawned engine's counts restart at zero, and the dead
        # incarnation's last published values carry over so the exported
        # counters stay monotone.
        self._dispatch_base: dict[str, float] = {}
        self._dispatch_rows: dict[str, int] = {}
        self._launch_base = 0.0
        # The lifecycle counters of a dead incarnation (drift triggers,
        # breaker trips, promotions by outcome), added to a fresh
        # controller's, which start at zero.
        self._life_base: dict[str, Any] | None = None
        self.lifecycle: Any = None
        self._requests_since_fetch = 0  # collector-thread writer

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._collector = threading.Thread(target=self._collect, name="ring-collector",
                                           daemon=True)
        self._collector.start()
        if (self._accumulating and self._mon_period > 0) or self.lifecycle is not None:
            self._start_telemetry()

    def _start_telemetry(self) -> None:
        self._telemetry = threading.Thread(target=self._telemetry_loop,
                                           name="ring-telemetry", daemon=True)
        self._telemetry.start()

    def attach_lifecycle(self, controller: Any) -> None:
        """Mirror ``controller``'s gauges into the ring on every telemetry
        tick and on ``stop``; the telemetry thread starts if the monitor
        cadence did not start it."""
        self.lifecycle = controller
        self._write_lifecycle()
        if self._telemetry is None and self._collector is not None:
            self._start_telemetry()

    def stop(self) -> None:
        """Drain: stop collecting, finish the jobs in flight, write the
        final monitor aggregate. Safe to call twice."""
        self._stop.set()
        self.ring.engine_doorbell.ring()  # wake the collector's select
        for thread in (self._collector, self._telemetry):
            if thread is not None:
                thread.join(timeout=10)
        self._pool.shutdown(wait=True)
        if self._accumulating:
            try:
                self.ring.write_monitor(self.engine.monitor_snapshot())
            except Exception:  # the drain goes on without a last snapshot
                logger.exception("final monitor snapshot failed on drain")
        self._write_lifecycle()

    # ------------------------------------------------------------ collect
    def _collect(self) -> None:
        ring = self.ring
        # Seeded with the entries already queued: their credit may have
        # died with a previous incarnation. Surplus credit after a pop is
        # dropped, never banked.
        credit = int(ring.sub_head[0]) - int(ring.sub_tail[0])
        while not self._stop.is_set():
            descs = ring.pop_submissions(limit=credit) if credit else []
            credit = 0
            if not descs:
                credit = ring.engine_doorbell.wait(timeout_s=1.0)
                continue
            self._requests_since_fetch += len(descs)
            for job in self._make_jobs(descs):
                # Backpressure: the dispatch bound blocks the collector,
                # submissions pile in the ring, front ends run out of
                # slots and shed: bounded end to end.
                self._inflight.acquire()
                self._pool.submit(self._run_job, job)

    def _slot_tier(self, slot: int) -> str | None:
        """The tier the slot's SLO class resolves to (None: the default
        tier); a replay resolves the same header the same way."""
        route = getattr(self.engine, "route_tier", None)
        return route(int(self.ring.slot_slo[slot])) if route is not None else None

    def _make_jobs(self, descs: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
        """Small requests group per tier, up to ``max_group`` a
        dispatch; everything else runs solo."""
        groupable: dict[str | None, list[tuple[int, int]]] = {}
        solo = []
        grouping = getattr(self.engine, "supports_grouping", False)
        for slot, gen in descs:
            if grouping and 1 <= int(self.ring.slot_n[slot]) <= GROUP_ROW_BUCKET:
                groupable.setdefault(self._slot_tier(slot), []).append((slot, gen))
            else:
                solo.append((slot, gen))
        jobs = []
        for tier in sorted(groupable, key=lambda t: t or ""):
            batch = groupable[tier]
            jobs += [batch[i:i + self.max_group] for i in range(0, len(batch), self.max_group)]
        return jobs + [[d] for d in solo]

    # ----------------------------------------------------------- reattach
    def reattach(self) -> dict[str, Any]:
        """Run by the engine process after warmup and before ``start``,
        on every boot (a first boot finds nothing to replay): bump the
        incarnation word (a dead incarnation's completions become
        droppable), recover the completion lock, seed the monitor totals,
        the mirrored counters and the lifecycle bases from shared memory,
        count the monitor rows that died unfetched with the old process,
        replay every busy slot whose descriptor is not still queued, and
        ring every worker's doorbell with its outstanding completion
        count."""
        # Fault point: delay = a slow re-attach; raise = a failed one (this
        # engine process exits and the supervisor forks another).
        faults.fire("serve.ring.reattach")
        ring = self.ring
        eng = ring.eng_vals
        incarnation = int(eng[ENG_INCARNATION]) + 1
        eng[ENG_INCARNATION] = incarnation
        ring.recover_engine_lock()
        if ring.life_vals[LIFE_HAS]:
            self._life_base = {
                "drift_triggers": float(ring.life_vals[LIFE_TRIGGERS]),
                "breaker_trips": float(ring.life_vals[LIFE_BREAKER_TRIPS]),
                "promotions": {outcome: float(ring.life_promos[i])
                               for i, outcome in enumerate(LIFE_OUTCOMES)},
            }
        self._dispatch_base = {k: float(v) for k, v in ring.dispatch_counts().items()}
        self._dispatch_rows = {k: i for i, k in enumerate(ring.dispatch_counts())}
        self._launch_base = float(ring.kernel_launches[0])
        mon = ring.mon_vals
        fetched = float(mon[MON_ROWS]) if mon[MON_HAS] else 0.0
        if self._accumulating and mon[MON_HAS]:
            self.engine.seed_monitor_totals(
                float(mon[MON_ROWS]), float(mon[MON_OUTLIERS]), float(mon[MON_BATCHES]),
                np.array(ring.mon_drift_sum), np.array(ring.mon_drift_last),
            )
        pending = ring.pending_submissions()
        replay = [(slot, int(ring.slot_gen[slot])) for slot in range(ring.n_slots)
                  if int(ring.slot_busy[slot]) and slot not in pending]
        replay_rows = sum(int(ring.slot_n[slot]) for slot, _ in replay)
        # Rows the dead engine folded on the device but no fetch
        # preserved, less those the replay folds again: counted, then the
        # baseline re-anchors to the fetched total so replayed rows land
        # once.
        rows_lost = 0.0
        if self._accumulating:
            rows_lost = max(0.0, float(eng[ENG_ROWS_DISPATCHED]) - fetched - replay_rows)
            eng[ENG_ROWS_LOST] += rows_lost
            eng[ENG_ROWS_DISPATCHED] = fetched
        if replay:
            jobs = []
            for job in self._make_jobs(replay):
                self._inflight.acquire()
                jobs.append(self._pool.submit(self._run_job, job))
            # Synchronous: every parked request is re-answered (or expired
            # against its own deadline) before the ready flag flips. A
            # failed replay re-raises: the engine exits and the supervisor
            # forks a fresh one.
            concurrent.futures.wait(jobs)
            for job in jobs:
                job.result()
            eng[ENG_REPLAYED] += len(replay)
            self._requests_since_fetch += len(replay)
        for worker in range(ring.workers):
            outstanding = int(ring.comp_head[worker]) - int(ring.comp_tail[worker])
            if outstanding > 0:
                ring.worker_doorbells[worker].ring(outstanding)
        with self._mon_lock:  # warmup's launches too, before the first scrape
            self._mirror_counts()
        return {"incarnation": incarnation, "replayed_slots": len(replay),
                "replay_rows": replay_rows, "monitor_rows_lost": rows_lost}

    # --------------------------------------------------------------- jobs
    def _run_job(self, job: list[tuple[int, int]]) -> None:
        ring = self.ring
        try:
            # Dead-work shedding: a descriptor whose deadline ran out while
            # it queued completes RESP_EXPIRED without a dispatch.
            now = time.monotonic()
            live, expired = [], []
            for slot, gen in job:
                deadline = float(ring.slot_deadline[slot])
                (expired if deadline and now >= deadline else live).append((slot, gen))
            raws, status = None, RESP_OK
            if live:
                try:
                    raws = self._score(live)
                # Any scoring failure becomes an error completion on every
                # waiting slot: a dropped descriptor would strand its
                # front end's future until the deadline.
                except Exception:
                    logger.exception("ring dispatch failed (%d slots)", len(live))
                    status = RESP_ERROR
            incarnation = int(ring.eng_vals[ENG_INCARNATION])
            with self._mon_lock:
                ring.eng_vals[ENG_EXPIRED] += len(expired)
                if live and status == RESP_OK and self._accumulating:
                    # Folded on the device, not yet preserved by a fetch:
                    # what a death of this process would lose.
                    ring.eng_vals[ENG_ROWS_DISPATCHED] += sum(
                        int(ring.slot_n[s]) for s, _ in live)
            for i, (slot, gen) in enumerate(live):
                # The stale-generation guard: never write the slab of a
                # slot that moved on; the completion still goes out (it
                # releases a quarantined slot).
                if status == RESP_OK and int(ring.slot_gen[slot]) == gen:
                    pred, out, drift = raws[i]
                    resp_pred, resp_out, resp_drift = ring.response_views(slot)
                    resp_pred[:] = pred
                    resp_out[:] = out
                    resp_drift[:] = drift
                ring.resp_status[slot] = status
                ring.resp_incarnation[slot] = incarnation
                ring.resp_gen[slot] = gen
            for slot, gen in expired:
                ring.resp_status[slot] = RESP_EXPIRED
                ring.resp_incarnation[slot] = incarnation
                ring.resp_gen[slot] = gen
            # The doorbell count is the owner's credit: ring after the
            # pushes, with how many landed.
            owners: dict[int, int] = {}
            for slot, gen in job:
                ring.push_completion(slot, gen)
                owner = ring.slot_owner(slot)
                owners[owner] = owners.get(owner, 0) + 1
            for worker, count in owners.items():
                ring.worker_doorbells[worker].ring(count)
        finally:
            self._inflight.release()

    def _score(self, job: list[tuple[int, int]]) -> list[tuple[np.ndarray, ...]]:
        """One job -> per-slot raw (predictions, outliers, drift). Several
        slots ride one grouped dispatch; the arrays arrive encoded, so
        the engine process does no per-record Python."""
        ring, engine = self.ring, self.engine
        tier = self._slot_tier(job[0][0])
        kwargs = {} if tier is None else {"tier": tier}
        parts = []
        for slot, _ in job:
            n = int(ring.slot_n[slot])
            cat, num = ring.request_views(slot)
            parts.append((cat[:n], num[:n]))
        if len(parts) >= 2:
            handle = engine.dispatch_group_arrays(parts, **kwargs)
            sizes, preds, outs, drifts = engine.fetch_group_raw(handle)
            raws = [(preds[i, :n], outs[i, :n], drifts[i]) for i, n in enumerate(sizes)]
        else:
            handle = engine.dispatch_arrays(*parts[0], **kwargs)
            raws = [engine.fetch_arrays_raw(handle)]
        # Counted under the tier that served: the engine resolves it under
        # its lock, so a job routed to the quant tier just before a
        # promotion to a bundle without one counts on the default tier.
        label = (getattr(handle, "tier", None) or tier
                 or getattr(engine, "default_tier", None))
        with self._mon_lock:
            if label in _TIER_IDX:
                ring.tier_counts[_TIER_IDX[label]] += len(job)
            self._mirror_counts()
        return raws

    def _mirror_counts(self) -> None:
        """Publish the engine's dispatches per program and the kernel's
        launches (plus the respawn bases); caller holds ``_mon_lock``, so
        the writes never go back in time."""
        ring = self.ring
        counts = getattr(self.engine, "dispatch_counts", dict)()
        for label in {*counts, *self._dispatch_base}:
            row = self._dispatch_rows.get(label)
            if row is None:
                row = len(self._dispatch_rows)
                if row >= DISPATCH_ROWS:
                    continue
                self._dispatch_rows[label] = row
                key = label.encode()[:DISPATCH_KEY_BYTES]
                ring.disp_keys[row] = 0
                ring.disp_keys[row, :len(key)] = np.frombuffer(key, np.uint8)
            ring.disp_vals[row] = self._dispatch_base.get(label, 0.0) + counts.get(label, 0)
        ring.kernel_launches[0] = self._launch_base + self._kernel_launches()

    # ----------------------------------------------------------- telemetry
    def _telemetry_loop(self) -> None:
        """Single-flight monitor reads, in the engine process only: after
        K ring requests, or when the period lapses with traffic
        outstanding (and once at start); never per request or scrape.
        Every tick also mirrors the lifecycle controller's gauges."""
        monitor = self._accumulating and self._mon_period > 0
        tick = min(0.25, self._mon_period) if monitor else 0.25
        last = time.monotonic()
        while not self._stop.wait(tick):
            self._write_lifecycle()
            if not monitor:
                continue
            due = (
                (self._mon_every and self._requests_since_fetch >= self._mon_every)
                or (time.monotonic() - last >= self._mon_period
                    and self._requests_since_fetch > 0)
                or not self.ring.mon_vals[MON_HAS]
            )
            if not due:
                continue
            self._requests_since_fetch = 0
            last = time.monotonic()
            try:
                self.ring.write_monitor(self.engine.monitor_snapshot())
            # A failed fetch keeps the last gauges; the next tick retries.
            except Exception:
                logger.exception("ring monitor fetch failed; gauges stale")

    def _write_lifecycle(self) -> None:
        """Mirror the controller's gauge snapshot, plus the dead
        incarnations' bases, into the ring (host reads and f64 stores, no
        device work)."""
        controller = self.lifecycle
        if controller is None:
            return
        try:
            snapshot = controller.metrics_snapshot()
            base = self._life_base
            if base and snapshot:
                snapshot = dict(snapshot)
                for key in ("drift_triggers", "breaker_trips"):
                    snapshot[key] = snapshot.get(key, 0) + base[key]
                promotions = dict(snapshot.get("promotions", {}))
                for outcome, count in base["promotions"].items():
                    promotions[outcome] = promotions.get(outcome, 0) + count
                snapshot["promotions"] = promotions
            self.ring.write_lifecycle(snapshot)
        # A controller mid-transition costs one gauge refresh, never the
        # telemetry thread.
        except Exception:
            logger.exception("ring lifecycle write failed; gauges stale")
