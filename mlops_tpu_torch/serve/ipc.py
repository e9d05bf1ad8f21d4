"""Shared-memory IPC of the ring plane: N HTTP front ends -> E engine
replicas, serving T tenants.

The port's copy of the JAX package's ``serve/ipc.py``. Front-end
processes validate and encode requests and write the feature arrays
straight into fixed-slot slabs of one shared memory segment; an engine
replica scores them (coalescing concurrent small requests of one tenant
into one grouped dispatch, as the in-process micro-batcher does) and
writes the raw response arrays back into the same slot. Only 8-byte
descriptors cross a queue: the arrays are never pickled or piped.

The engine replica set (``replicaset/``): every queue, doorbell and lock
an engine consumes or produces is per replica. Replica r owns submission
queue r (its own doorbell, its own credit), pushes completions into its
own per-worker completion queues under its own completion lock, and
mirrors its telemetry into its own row of every engine-written block. The
front ends' ``ReplicaRouter`` picks the replica of each submit. A ``kill
-9`` of replica k is a brownout of 1/E of capacity: only k's queues stall,
the router routes new admissions around it, and k's respawned incarnation
replays exactly the busy slots tagged ``slot_replica == k``.

The tenant fleet (``tenancy/``): a front end tags each slot with its
tenant at claim (``slot_tenant``); the engine dispatches the slot against
that tenant's engine, never grouping two tenants into one dispatch, and a
replay re-answers it under the same tenant. The request counters are per
(worker, tenant), the monitor aggregate per (replica, tenant), the
lifecycle row per tenant. ``replicas=1`` and the one-tenant
``("default",)`` fleet are the plane without either axis.

Topology and ownership:

- One anonymous ``mmap`` (``MAP_SHARED``) built by the supervisor before
  it forks anything; every process sees the same pages by inheritance.
- Every front end owns a fixed partition of the slots: claim and release
  are confined to its event loop. The only cross-process lock a front end
  takes is a submission queue's (producers only); a completion queue's
  belongs to its replica's engine threads alone. Both consumers are
  lock-free and fenced by a counted doorbell instead: the ``eventfd``
  value is the number of entries published, and a consumer consumes only
  what a drained doorbell credited.
- Two slot classes per worker: small slabs of ``GROUP_ROW_BUCKET`` rows
  (the coalescable class) and large slabs of ``max_batch`` rows (solo
  dispatches; on a one-tenant plane a small request may overflow into a
  free large slab, never the reverse). An exhausted class is the shed
  signal: 503 with Retry-After, never an unbounded queue.
- Per-slot generations: a front end bumps the slot's generation at
  submit, the engine stamps the response with it, and a completion with
  a stale generation is dropped, so a respawned front end is never handed
  a dead request's answer.
- Each replica's incarnation word: a respawned replica bumps its own,
  recovers its own completion lock, seeds each tenant's monitor totals
  from its own rows of the shared aggregate, carries the dead
  incarnation's counters as bases (exported counters stay monotone) and
  replays every busy slot of its own whose completion never came
  (``RingService.reattach``). The slabs hold the full encoded input and
  the packed programs are pure, so a replayed answer is bit-identical.
  Completions stamped by a dead incarnation are dropped on arrival.

Lock discipline: locks guard index arithmetic only; slab reads and writes
happen outside every lock, on slots exclusively owned between claim and
release. ``RequestRing._submit_locks[r]`` and ``._complete_locks[r]`` are
the cross-process locks, one per descriptor queue's head index, per
engine replica r. Beyond mutual exclusion they order the producers'
stores against the head bump. Only front ends acquire a
``_submit_locks`` entry and only replica r's engine threads acquire
``_complete_locks[r]``, so a ``kill -9`` on either side never orphans a
lock any other process needs: an engine replica's death is a 1/E
brownout, not a wedge. The one residual case, a dead replica's own
completion lock, is recovered by its successor in
``recover_engine_locks``: the supervisor runs at most one incarnation of
each replica, and no replica ever takes another replica's lock. All queue
locks are leaves. In ``RingService``: ``_inflight`` (the dispatch bound,
taken by the collector and released by the pool thread that finishes the
job) is outermost, ``_mon_lock`` a leaf.

Observability (``trace/``, ``slo/``), the JAX ring's: ``ctl[2]`` arms
tracing (the engine then stamps each slot's engine half into
``resp_trace``: collected, job started, dispatched, fetched, and the
entry's kind and geometry, which the owning front end stitches into its
span); ``ctl[3]`` arms the SLO block (``slo_meta`` carries its windows;
the lead replica mirrors its ``SLOEngine`` into ``slo_vals`` and
``alert_vals``). Each replica mirrors its shape histograms and cost ledger
into its own table rows. ``/debug/profile`` crosses the ring as two
single-word messages (``prof_ctl``: the request ``seq << 8 | action``,
the answer ``seq << 16 | status``) under a claim lease (``prof_claim``),
answered by replica 0 off its collector thread. The autotuner
(``autotune/``): each replica's telemetry loop mirrors its controller's
gauges into its own ``auto_vals`` / ``auto_plans`` rows.

Nothing here imports torch: front ends import this module, and the
engine side reaches the device only through the engines it is given.
"""

from __future__ import annotations

import concurrent.futures
import logging
import mmap
import multiprocessing
import os
import queue
import select
import threading
import time
from typing import Any, Callable

import numpy as np

from mlops_tpu_torch import faults
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.metrics import (
    AUTO_GRID_GEN,
    AUTO_HAS,
    AUTO_HAS_MEAS,
    AUTO_HAS_PRED,
    AUTO_MEAS_GAIN,
    AUTO_PRED_GAIN,
    AUTOTUNE_OUTCOMES,
    ENG_DEGRADED,
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
    SLO_BAD_STATUSES,
    latency_good_buckets,
)
from mlops_tpu_torch.serve.tierroute import TIERS
from mlops_tpu_torch.slo import ledger as _ledger
from mlops_tpu_torch.slo.engine import N_ENGINE_ALERTS, SLO_FIELDS
from mlops_tpu_torch.trace import shapes as _shapes
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
# An engine replica's dispatches per program label, mirrored into a fixed
# table of its own: rows are assigned in first-seen order and never move.
DISPATCH_ROWS = 128
DISPATCH_KEY_BYTES = 32
# Control words: [0] reserved (readiness is per replica, rep_ready),
# [1] draining, [2] tracing armed, [3] SLOs armed.
CTL_DRAINING, CTL_TRACING, CTL_SLO = 1, 2, 3
# /debug/profile actions on the request word.
PROFILE_ACTIONS = {"start": 1, "stop": 2}


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
                 large_rows: int, small_rows: int = GROUP_ROW_BUCKET,
                 tenant_names: tuple[str, ...] = ("default",),
                 replicas: int = 1) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if not tenant_names:
            raise ValueError("tenant_names must name at least one tenant")
        self.workers = workers
        # A replica's index is its position on every per-replica axis and
        # a tenant's its position in ``tenant_names``, both fixed for the
        # plane's lifetime (the names are plain state inherited through
        # fork, never stored in shared memory).
        self.replicas = R = replicas
        self.tenant_names = tuple(tenant_names)
        self.tenants = T = len(self.tenant_names)
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
            # /debug/profile: [0] the request word (seq << 8 | action), [1]
            # the answer (seq << 16 | http status); each one u64 store, so
            # neither tears. prof_claim is the channel's lease (its
            # monotonic expiry; 0 = free): a front end killed mid-wait
            # frees it by expiry.
            ("prof_ctl", u64, (2,)),
            ("prof_claim", f64, (1,)),
            # Per-replica readiness: replica r's engine flips its own word
            # at attach, the supervisor clears it when r dies. The plane
            # is ready while any replica is.
            ("rep_ready", u64, (R,)),
            # Per-(worker, replica) live ring depth: slots this worker
            # routed to replica r and has not released (single writer:
            # that worker); the router sums a replica's column.
            ("rep_inflight", u64, (workers, R)),
            # One submission queue per replica (front ends -> replica r's
            # collector).
            ("sub_entries", u64, (R, self.n_slots)),
            ("sub_head", u64, (R,)),
            ("sub_tail", u64, (R,)),
            # One completion queue per (replica, worker). A slot completes
            # on the replica it was routed to, so a worker's slot count
            # bounds each row.
            ("comp_entries", u64, (R, workers, slots_small + slots_large)),
            ("comp_head", u64, (R, workers)),
            ("comp_tail", u64, (R, workers)),
            # Slot headers. slot_busy marks submitted-but-unreleased slots
            # in shared memory, so a respawned front end quarantines them
            # (an engine may still write their slabs) and a respawned
            # replica replays its own. slot_tenant (stamped at claim) and
            # slot_replica (stamped at submit, before the busy flag) name
            # the engine that dispatches and replays the slot. slot_slo is
            # the routed SLO class (after brownout demotion): the dispatch
            # and a replay resolve the same tier from it. slot_deadline is
            # the absolute CLOCK_MONOTONIC deadline (0: none), which the
            # engine checks before dispatching.
            ("slot_gen", u32, (self.n_slots,)),
            ("slot_n", u32, (self.n_slots,)),
            ("slot_busy", u32, (self.n_slots,)),
            ("slot_tenant", u32, (self.n_slots,)),
            ("slot_replica", u32, (self.n_slots,)),
            ("slot_slo", u32, (self.n_slots,)),
            ("slot_deadline", f64, (self.n_slots,)),
            ("resp_gen", u32, (self.n_slots,)),
            ("resp_status", u32, (self.n_slots,)),
            ("resp_incarnation", u32, (self.n_slots,)),
            # The engine half of a traced slot's span: [collected, job
            # started, dispatched, fetched] CLOCK_MONOTONIC stamps and
            # [kind, geometry] of the entry that served (kind 1: bucket of
            # geometry rows; 2: group, geometry slots * 100000 + rows).
            # Written before the completion push, read by the owner before
            # release (the response slab's ownership window); zeroed at
            # submit, so a slot a dead incarnation left half-stamped is
            # stitched whole or not at all.
            ("resp_trace", f64, (self.n_slots, 6)),
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
            # Per-(worker, tenant) serving stats (single writer: that
            # worker).
            ("req_counts", u64, (workers, T, len(ROUTES), len(RING_STATUSES) + 1)),
            ("lat_counts", u64, (workers, T, len(LATENCY_BUCKETS))),
            ("lat_sum_ms", f64, (workers, T)),
            ("lat_n", u64, (workers, T)),
            # The latency SLO's scope: /predict requests only.
            ("pred_lat_counts", u64, (workers, T, len(LATENCY_BUCKETS))),
            ("pred_lat_n", u64, (workers, T)),
            ("shed", u64, (workers, T, 2)),
            ("inflight", u64, (workers, T, 2)),
            # Admissions refused by the tenant's own weighted max-min
            # floor, not by physical exhaustion.
            ("quota_shed", u64, (workers, T)),
            ("expired", u64, (workers,)),
            # Requests admitted while every replica is down, holding a
            # slot for a respawned replica's replay (a gauge), and sheds
            # of a full partition during such an outage.
            ("parked", u64, (workers,)),
            ("brownout_shed", u64, (workers,)),
            ("tier_demote", u64, (workers,)),
            ("brownout_demote", u64, (workers,)),
            # Spans each front end's recorder dropped and flight-recorder
            # dumps it landed (single writer: that worker).
            ("trace_dropped", u64, (workers,)),
            ("flight_dumps", u64, (workers,)),
            # Engine-process writers, one row per replica (under that
            # replica's RingService._mon_lock); the render sums them.
            ("tier_counts", f64, (R, len(TIERS))),
            # The monitor aggregate, one row per (replica, tenant); the
            # render folds the replica axis. mon_drift_sum carries the
            # unrounded cumulative sums a respawned replica seeds each
            # tenant's exact host totals from.
            ("mon_vals", f64, (R, T, 8)),
            ("mon_drift_last", f64, (R, T, D)),
            ("mon_drift_mean", f64, (R, T, D)),
            ("mon_drift_sum", f64, (R, T, D)),
            # Engine supervision, one row per replica (serve/metrics.py
            # ENG_*); eng_rows_tenant holds the per-tenant rows-dispatched
            # baselines a respawn's rows-lost accounting differences.
            ("eng_vals", f64, (R, 8)),
            ("eng_rows_tenant", f64, (R, T)),
            ("disp_keys", np.dtype(np.uint8), (R, DISPATCH_ROWS, DISPATCH_KEY_BYTES)),
            ("disp_vals", f64, (R, DISPATCH_ROWS)),
            ("kernel_launches", f64, (R,)),
            # The engine-side lifecycle loops' gauges, one row per tenant
            # (the lead replica's telemetry thread writes them; see
            # serve/metrics.py LIFE_*), so any front end renders them.
            ("life_vals", f64, (T, 8)),
            ("life_promos", f64, (T, len(LIFE_OUTCOMES))),
            # Each replica's shape histograms (trace/shapes.py): its
            # telemetry thread writes the table, shape_meta[r] is the
            # stats' armed-at clock (0: tracing off), shape_evicted[r] the
            # entries its table could not hold.
            ("shape_meta", f64, (R,)),
            ("shape_keys", np.dtype(np.uint8),
             (R, _shapes.TABLE_ROWS, _shapes.TABLE_KEY_BYTES)),
            ("shape_vals", f64, (R, _shapes.TABLE_ROWS, _shapes.TABLE_VALS)),
            ("shape_evicted", f64, (R,)),
            # The SLO block: its geometry (four windows, two targets, the
            # latency threshold; the supervisor's, before the fork) and the
            # per-tenant rows the lead replica mirrors every tick.
            ("slo_meta", f64, (8,)),
            ("slo_vals", f64, (T, SLO_FIELDS)),
            ("alert_vals", f64, (T, N_ENGINE_ALERTS)),
            # Each replica's cost ledger (slo/ledger.py); ledger_meta[r] >
            # 0 once replica r mirrored one.
            ("ledger_meta", f64, (R,)),
            ("ledger_keys", np.dtype(np.uint8),
             (R, _ledger.TABLE_ROWS, _ledger.TABLE_KEY_BYTES)),
            ("ledger_vals", f64, (R, _ledger.TABLE_ROWS, _ledger.TABLE_VALS)),
            # Each replica's autotune controller (serve/metrics.py AUTO_*):
            # its grid generation and gain audit, and its plans by outcome
            # (single writer: that replica's telemetry loop).
            ("auto_vals", f64, (R, 6)),
            ("auto_plans", f64, (R, len(AUTOTUNE_OUTCOMES))),
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
        # Serializes the profile channel's word updates (never held across
        # the wait for an answer: the lease is the ownership).
        self._profile_lock = ctx.Lock()
        self._submit_locks = [ctx.Lock() for _ in range(R)]  # front ends only
        self._complete_locks = [ctx.Lock() for _ in range(R)]  # replica r only
        self.engine_doorbells = [Doorbell() for _ in range(R)]
        # Flat [worker * replicas + replica]: a one-replica plane's
        # worker_doorbells[w] is worker w's one doorbell.
        self.worker_doorbells = [Doorbell() for _ in range(workers * R)]

    # ---------------------------------------------------------- doorbells
    @property
    def engine_doorbell(self) -> Doorbell:
        """Replica 0's submission doorbell."""
        return self.engine_doorbells[0]

    def worker_doorbell(self, worker: int, replica: int = 0) -> Doorbell:
        """The doorbell replica ``replica`` rings for ``worker``'s
        completions (one per pair: the counted credit fences one queue)."""
        return self.worker_doorbells[worker * self.replicas + replica]

    # ------------------------------------------------------ control words
    @property
    def engine_ready(self) -> bool:
        """Any replica ready: the router routes around the rest."""
        return bool(self.rep_ready.any())

    def set_ready(self, ready: bool, replica: int | None = None) -> None:
        """Flip one replica's readiness word (its engine at attach, the
        supervisor at its death), or with ``replica`` None every one."""
        if replica is None:
            self.rep_ready[:] = 1 if ready else 0
        else:
            self.rep_ready[replica] = 1 if ready else 0

    def ready_replicas(self) -> list[int]:
        return [r for r in range(self.replicas) if self.rep_ready[r]]

    @property
    def draining(self) -> bool:
        return bool(self.ctl[CTL_DRAINING])

    def set_draining(self) -> None:
        self.ctl[CTL_DRAINING] = 1

    @property
    def tracing(self) -> bool:
        return bool(self.ctl[CTL_TRACING])

    def set_tracing(self, armed: bool) -> None:
        self.ctl[CTL_TRACING] = 1 if armed else 0

    @property
    def slo_armed(self) -> bool:
        return bool(self.ctl[CTL_SLO])

    def arm_slo(self, slo_config) -> None:
        """The supervisor, before any fork: publish the SLO geometry (every
        front end labels the windows from it) and flip the flag that gates
        the block."""
        for i, value in enumerate((
            slo_config.fast_short_s, slo_config.fast_long_s,
            slo_config.slow_short_s, slo_config.slow_long_s,
            slo_config.availability_target, slo_config.latency_target,
            slo_config.latency_threshold_ms,
        )):
            self.slo_meta[i] = float(value)
        self.ctl[CTL_SLO] = 1

    def slo_counts(self, latency_threshold_ms: float) -> dict[str, tuple[int, int, int, int]]:
        """The SLO engine's counter source on the ring: per tenant, the
        cumulative ``(avail_good, avail_total, lat_good, lat_total)`` of
        ``/predict`` over every worker's rows (lock-free reads of monotone
        counters; a racing increment lands in the next tick)."""
        route = _ROUTE_IDX["/predict"]
        bad = [_STATUS_IDX[s] for s in SLO_BAD_STATUSES]
        k = latency_good_buckets(latency_threshold_ms)
        out = {}
        for t, tenant in enumerate(self.tenant_names):
            counts = self.req_counts[:, t, route, :]
            total = int(counts.sum())
            out[tenant] = (total - int(counts[:, bad].sum()), total,
                           int(self.pred_lat_counts[:, t, :k].sum()),
                           int(self.pred_lat_n[:, t].sum()))
        return out

    # ---------------------------------------------------- profile channel
    # The lease outlives a front end's wait for the answer (10 s), so a
    # live waiter is never usurped; a dead one frees by expiry.
    PROFILE_LEASE_S = 15.0

    def try_claim_profile(self) -> float | None:
        """Claim the channel without waiting (busy: None, the caller
        answers 409). Returns the lease token: releasing and cancelling
        need it, so a claimant stalled past its expiry cannot clobber a
        successor."""
        if not self._profile_lock.acquire(timeout=0.2):
            return None
        try:
            now = time.monotonic()
            if float(self.prof_claim[0]) > now:
                return None
            token = now + self.PROFILE_LEASE_S
            self.prof_claim[0] = token
            return token
        finally:
            self._profile_lock.release()

    def release_profile(self, token: float) -> None:
        with self._profile_lock:
            if float(self.prof_claim[0]) == token:
                self.prof_claim[0] = 0.0

    def post_profile_request(self, action_code: int) -> int:
        """Publish the next request word (the caller holds the lease); the
        seq its answer echoes. No doorbell: that count is the submission
        queue's credit, and the collector reads this word on every pass
        (at least once a second)."""
        with self._profile_lock:
            seq = ((int(self.prof_ctl[0]) >> 8) + 1) & 0xFFFFFFFF
            seq = seq or 1  # 0 reads as "no request"
            self.prof_ctl[0] = (seq << 8) | (action_code & 0xFF)
        return seq

    def read_profile_ack(self, seq: int) -> int | None:
        """The engine's HTTP status for ``seq``, None while pending."""
        resp = int(self.prof_ctl[1])
        return resp & 0xFFFF if (resp >> 16) == seq else None

    def cancel_profile_request(self, seq: int, token: float) -> None:
        """A timed-out wait: overwrite a request not yet read with a no-op
        at the same seq (the engine answers it 404 instead of running a
        start or stop the client was told failed)."""
        with self._profile_lock:
            if float(self.prof_claim[0]) == token:
                self.prof_ctl[0] = (int(seq) << 8) | 0

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
    def submit(self, slot: int, gen: int, replica: int = 0) -> None:
        """Front-end side: enqueue a filled slot for ``replica``. The lock
        (producers only) orders the slab stores before the head bump; the
        doorbell rings outside it with one unit of credit."""
        with self._submit_locks[replica]:
            head = int(self.sub_head[replica])
            self.sub_entries[replica, head % self.n_slots] = _pack(slot, gen)
            self.sub_head[replica] = head + 1
        self.engine_doorbells[replica].ring()

    def pop_submissions(self, limit: int | None = None,
                        replica: int = 0) -> list[tuple[int, int]]:
        """Engine side, the one consumer of ``replica``'s queue, lock-free:
        at most ``limit`` entries (the doorbell credit), so an entry is
        consumed only after a doorbell rung after its publication was
        drained."""
        head, tail = int(self.sub_head[replica]), int(self.sub_tail[replica])
        if limit is not None:
            head = min(head, tail + limit)
        out = [_unpack(int(self.sub_entries[replica, i % self.n_slots]))
               for i in range(tail, head)]
        self.sub_tail[replica] = head if head > tail else tail
        return out

    def pending_submissions(self, replica: int = 0) -> set[int]:
        """Slots with a descriptor queued for ``replica`` but not popped:
        the re-attach replay leaves them to the collector."""
        head, tail = int(self.sub_head[replica]), int(self.sub_tail[replica])
        return {_unpack(int(self.sub_entries[replica, i % self.n_slots]))[0]
                for i in range(tail, head)}

    def recover_engine_locks(self, replica: int = 0) -> None:
        """A respawned replica frees its own completion lock, which its
        predecessor may have died holding. Safe because only that
        replica's engine processes take it, the supervisor runs one
        incarnation of each replica at a time, and this runs before the
        new engine starts a thread: a failed try-acquire can only be an
        orphaned hold. Sibling replicas' locks are untouched: their
        owners are alive."""
        lock = self._complete_locks[replica]
        if lock.acquire(block=False):
            lock.release()
            return
        lock.release()
        logger.warning("recovered the completion lock of dead engine replica %d", replica)

    def push_completion(self, slot: int, gen: int, replica: int = 0) -> None:
        """Engine side: hand a finished slot back to its owner through
        ``replica``'s own queue row."""
        worker = self.slot_owner(slot)
        cap = self.comp_entries.shape[2]
        with self._complete_locks[replica]:
            head = int(self.comp_head[replica, worker])
            self.comp_entries[replica, worker, head % cap] = _pack(slot, gen)
            self.comp_head[replica, worker] = head + 1

    def pop_completions(self, worker: int, limit: int | None = None,
                        replica: int = 0) -> list[tuple[int, int]]:
        """Front-end side, lock-free and credit-fenced like
        ``pop_submissions``, on one (replica, worker) queue."""
        cap = self.comp_entries.shape[2]
        head = int(self.comp_head[replica, worker])
        tail = int(self.comp_tail[replica, worker])
        if limit is not None:
            head = min(head, tail + limit)
        out = [_unpack(int(self.comp_entries[replica, worker, i % cap]))
               for i in range(tail, head)]
        if head > tail:
            self.comp_tail[replica, worker] = head
        return out

    # ---------------------------------------------- engine-written tables
    def write_monitor(self, snapshot: dict[str, Any], tenant: int = 0,
                      replica: int = 0) -> None:
        """Install one tenant engine's ``monitor_snapshot`` in its
        (replica, tenant) row for the front ends' renders. Field-at-a-time
        f64 stores; a scrape racing this write may see a mix, which gauges
        tolerate."""
        row = self.mon_vals[replica, tenant]
        row[MON_ROWS] = float(snapshot["rows"])
        row[MON_OUTLIERS] = float(snapshot["outliers"])
        row[MON_BATCHES] = float(snapshot["batches"])
        self.mon_drift_last[replica, tenant] = list(snapshot["drift_last"].values())
        self.mon_drift_mean[replica, tenant] = list(snapshot["drift_mean"].values())
        self.mon_drift_sum[replica, tenant] = snapshot["drift_sum"]
        row[MON_FETCHES] += 1
        row[MON_FETCHED_AT] = time.monotonic()
        row[MON_HAS] = 1.0

    def write_lifecycle(self, snapshot: dict[str, Any], tenant: int = 0) -> None:
        """Install one tenant's lifecycle controller ``metrics_snapshot``
        for the front ends' renders (the same tearing contract as
        ``write_monitor``)."""
        if not snapshot:
            return
        row = self.life_vals[tenant]
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
            self.life_promos[tenant, i] = float(promotions.get(outcome, 0))
        row[LIFE_HAS] = 1.0

    def write_autotune(self, snapshot: dict[str, Any], replica: int = 0) -> None:
        """Install one replica's autotune controller ``metrics_snapshot``
        for the front ends' renders (the same tearing contract as
        ``write_monitor``)."""
        if not snapshot:
            return
        row = self.auto_vals[replica]
        row[AUTO_GRID_GEN] = float(snapshot["grid_generation"])
        predicted = snapshot.get("predicted_gain_pct")
        row[AUTO_PRED_GAIN] = 0.0 if predicted is None else float(predicted)
        row[AUTO_HAS_PRED] = 0.0 if predicted is None else 1.0
        measured = snapshot.get("measured_gain_pct")
        row[AUTO_MEAS_GAIN] = 0.0 if measured is None else float(measured)
        row[AUTO_HAS_MEAS] = 0.0 if measured is None else 1.0
        plans = snapshot.get("plans", {})
        for i, outcome in enumerate(AUTOTUNE_OUTCOMES):
            self.auto_plans[replica, i] = float(plans.get(outcome, 0))
        row[AUTO_HAS] = 1.0

    def dispatch_counts(self, replica: int | None = None) -> dict[str, int]:
        """Mirrored dispatches per program label: one replica's, or with
        ``replica`` None the plane's, summed over replicas by label."""
        out: dict[str, int] = {}
        rows = range(self.replicas) if replica is None else (replica,)
        for r in rows:
            for key, count in zip(self.disp_keys[r], self.disp_vals[r]):
                label = bytes(key).rstrip(b"\0").decode()
                if label:
                    out[label] = out.get(label, 0) + int(count)
        return out

    def close(self) -> None:
        for bell in (*self.engine_doorbells, *self.worker_doorbells):
            bell.close()


class ShmWorkerMetrics:
    """The request recorder of one front end, writing its row of the
    shared stats: single writer (that worker's event loop), so no lock;
    readers see monotone counters."""

    def __init__(self, ring: RequestRing, worker: int, default_tenant: int = 0) -> None:
        self._ring = ring
        self._worker = worker
        # Tenant label -> row. Labels are bounded upstream
        # (TenantRouter.bill_label): every one is a declared tenant.
        self._tenant_idx = {name: i for i, name in enumerate(ring.tenant_names)}
        self._default_tenant = int(default_tenant)

    def observe_request(self, route: str, status: int, latency_ms: float,
                        tenant: str = "default") -> None:
        ring, w = self._ring, self._worker
        t = self._tenant_idx.get(tenant, self._default_tenant)
        r = _ROUTE_IDX.get(route, _ROUTE_IDX["<other>"])
        ring.req_counts[w, t, r, _STATUS_IDX.get(status, len(RING_STATUSES))] += 1
        ring.lat_sum_ms[w, t] += latency_ms
        ring.lat_n[w, t] += 1
        for i, edge in enumerate(LATENCY_BUCKETS):
            if latency_ms <= edge:
                ring.lat_counts[w, t, i] += 1
                if route == "/predict":  # the latency SLO's scope
                    ring.pred_lat_counts[w, t, i] += 1
                break
        if route == "/predict":
            ring.pred_lat_n[w, t] += 1

    def count_deadline_expired(self) -> None:
        """A request answered 504 before its slot was submitted."""
        self._ring.expired[self._worker] += 1


class RingClient:
    """One front end's view of the ring: slot claim, submit and release,
    and the per-replica completion doorbells. Everything here is confined
    to the owning worker's event loop."""

    def __init__(self, ring: RequestRing, worker: int, affinity_slack: int = 4) -> None:
        from mlops_tpu_torch.replicaset.router import ReplicaRouter

        self.ring = ring
        self.worker = worker
        # The replica of each submit: least-loaded by live ring depth,
        # sticky per (tenant, class) on the coalescable class.
        self.router = ReplicaRouter(ring, affinity_slack=affinity_slack)
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
        for slot in (*small, *large):
            ring.slot_gen[slot] += 1
            if int(ring.slot_busy[slot]):
                self._quarantined.add(slot)
            else:
                self._free[ring.slot_class(slot)].append(slot)
        # The depth gauges restart at the quarantined slots, attributed by
        # their shared-memory tenant and replica tags: the router keeps
        # seeing a crashed worker's in-flight load on its replica.
        ring.inflight[worker] = 0
        ring.rep_inflight[worker] = 0
        self._routed: set[int] = set(self._quarantined)
        for slot in self._quarantined:
            tenant = int(ring.slot_tenant[slot]) % ring.tenants
            ring.inflight[worker, tenant, ring.slot_class(slot)] += 1
            ring.rep_inflight[worker, int(ring.slot_replica[slot]) % ring.replicas] += 1
        # The dead incarnation's parked requests died with its
        # connections.
        ring.parked[worker] = 0
        # Completion credit per replica queue, seeded with the entries
        # already queued, whose doorbell a dead incarnation may have
        # drained.
        self._credit = [int(ring.comp_head[r, worker]) - int(ring.comp_tail[r, worker])
                        for r in range(ring.replicas)]
        # slot -> (generation, future). A future that gave up waiting (a
        # deadline) leaves a zombie: the slot is reused only once the
        # engine's completion arrives.
        self._pending: dict[int, tuple[int, Any]] = {}

    def claim(self, n_rows: int, slo: int = 0, tenant: int = 0,
              allow_overflow: bool = True) -> int | None:
        """A free slot whose slab fits ``n_rows``, or None (shed). A small
        request may overflow into a large slab only with
        ``allow_overflow`` (a multi-tenant plane passes False: its
        per-class quota governors admit against the class the row count
        names). The tenant and the routed SLO class ride the slot header,
        stamped before any counter moves."""
        small_free, large_free = self._free
        if n_rows <= self.ring.small_rows:
            if small_free:
                slot = small_free.pop()
            elif allow_overflow and large_free:
                slot = large_free.pop()
            else:
                return None
        elif large_free:
            slot = large_free.pop()
        else:
            return None
        self.ring.slot_tenant[slot] = tenant
        self.ring.slot_slo[slot] = slo
        self.ring.inflight[self.worker, tenant, self.ring.slot_class(slot)] += 1
        return slot

    def count_shed(self, n_rows: int, tenant: int = 0) -> None:
        cls = SMALL if n_rows <= self.ring.small_rows else LARGE
        self.ring.shed[self.worker, tenant, cls] += 1

    def count_quota_shed(self, tenant: int) -> None:
        """One admission refused by the tenant's own weighted max-min
        quota (free slots existed; its floor did not allow the claim)."""
        self.ring.quota_shed[self.worker, tenant] += 1

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
               deadline: float | None = None, replica: int | None = None):
        """Write the encoded arrays into the slot's slab and enqueue it on
        one replica's queue (``replica`` None: the router's choice); the
        asyncio future the completion resolves with the engine's status.
        ``deadline`` is absolute ``time.monotonic`` seconds."""
        import asyncio

        n = cat.shape[0]
        ring = self.ring
        if replica is None:
            replica = self.router.route(int(ring.slot_tenant[slot]), ring.slot_class(slot))
        slab_cat, slab_num = ring.request_views(slot)
        slab_cat[:n] = cat
        slab_num[:n] = num
        ring.slot_n[slot] = n
        ring.slot_deadline[slot] = deadline if deadline is not None else 0.0
        if ring.tracing:
            ring.resp_trace[slot] = 0.0
        # The replica tag before busy, busy before the descriptor: a
        # worker dying anywhere past here leaves the slot, tagged with its
        # replica, to the next incarnation's quarantine and that replica's
        # replay.
        ring.slot_replica[slot] = replica
        gen = (int(ring.slot_gen[slot]) + 1) & 0xFFFFFFFF
        ring.slot_gen[slot] = gen
        ring.slot_busy[slot] = 1
        self._routed.add(slot)
        ring.rep_inflight[self.worker, replica] += 1
        future = asyncio.get_running_loop().create_future()
        self._pending[slot] = (gen, future)
        ring.submit(slot, gen, replica)
        return future

    def _free_slot(self, slot: int) -> None:
        ring = self.ring
        ring.slot_busy[slot] = 0
        cls = ring.slot_class(slot)
        self._free[cls].append(slot)
        ring.inflight[self.worker, int(ring.slot_tenant[slot]) % ring.tenants, cls] -= 1
        if slot in self._routed:
            # Submitted slots count toward their replica's depth; a claim
            # released unsubmitted never did.
            self._routed.discard(slot)
            ring.rep_inflight[self.worker, int(ring.slot_replica[slot]) % ring.replicas] -= 1

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

    def on_doorbell(self, replica: int = 0) -> None:
        """Event-loop reader callback of ``replica``'s doorbell for this
        worker: drain the completions it credited, resolve live futures,
        release zombies, and drain the quarantine (the engine answering a
        slot proves its slab is quiescent). Credit beyond what pops is
        surplus and dropped: entries always arrive with their own ring."""
        ring = self.ring
        credit = self._credit[replica] + ring.worker_doorbell(self.worker, replica).drain()
        self._credit[replica] = 0
        for slot, gen in ring.pop_completions(self.worker, limit=credit, replica=replica):
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
            elif int(ring.resp_incarnation[slot]) != int(ring.eng_vals[replica, ENG_INCARNATION]):
                # Produced by a dead incarnation of this replica: nothing
                # it left is trusted; its successor's replay re-answers,
                # or the deadline turns the wait into a 504 and the zombie
                # path reclaims.
                logger.info("dropping slot %d's completion from dead engine replica %d "
                            "incarnation %d", slot, replica,
                            int(ring.resp_incarnation[slot]))
            elif int(ring.resp_gen[slot]) != gen:
                logger.error("slot %d completed gen %d but its slab carries gen %d",
                             slot, gen, int(ring.resp_gen[slot]))
            else:
                future.set_result(int(ring.resp_status[slot]))

    def pending_count(self) -> int:
        return len(self._pending)


class RingService:
    """The engine-replica half: collect the slots submitted to this
    replica, coalesce small requests of one tenant and one tier into
    grouped dispatches through that tenant's engine's two-phase API
    (``dispatch_group_arrays`` / ``fetch_group_raw``, the path the
    micro-batcher takes), run jobs on a thread pool so dispatches overlap,
    write raw responses into the slabs and ring the owners' doorbells. It
    answers every accepted descriptor (scored, failed or expired), and
    never waits on front-end state. ``engines[t]`` serves tenant ``t``
    (one engine is the one-tenant fleet). With lifecycle controllers
    attached (``attach_lifecycle``), its telemetry thread also mirrors
    each tenant's gauges into its lifecycle row. Observability attaches
    after construction, before ``start``: ``slo`` (an ``SLOEngine``, the
    lead replica's, ticked on the telemetry thread against the ring's
    counters and mirrored into the SLO rows), ``cost_ledger`` (mirrored
    into this replica's ledger table) and ``profiler`` (the engine side of
    ``/debug/profile``: ``TorchProfiler.control``, replica 0 only). The
    shape histograms are the engines' ``shape_stats``."""

    def __init__(self, engine: Any, ring: RequestRing, max_group: int = 64,
                 max_inflight: int = 4, threads: int = 8,
                 monitor_fetch_every_s: float = 2.0,
                 monitor_fetch_every_requests: int = 512,
                 kernel_launches: Callable[[], int] = lambda: 0,
                 engines: list[Any] | None = None, replica: int = 0) -> None:
        self.engine = engine
        self.engines: list[Any] = list(engines) if engines is not None else [engine]
        if len(self.engines) != ring.tenants:
            raise ValueError(f"{len(self.engines)} engines but the ring carries "
                             f"{ring.tenants} tenant rows")
        self.replica = int(replica)
        if not 0 <= self.replica < ring.replicas:
            raise ValueError(f"replica {replica} outside the ring's {ring.replicas} "
                             "replica rows")
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
        self._accumulating = [
            bool(getattr(eng, "monitor_accumulating", hasattr(eng, "monitor_snapshot")))
            for eng in self.engines]
        self._kernel_launches = kernel_launches
        # Respawn bases of the mirrored counters (set by ``reattach``): a
        # respawned replica's counts restart at zero, and its dead
        # incarnation's last published values carry over so the exported
        # counters stay monotone.
        self._dispatch_base: dict[str, float] = {}
        self._dispatch_rows: dict[str, int] = {}
        self._launch_base = 0.0
        # Per tenant row: the lifecycle counters of a dead incarnation
        # (drift triggers, breaker trips, promotions by outcome), added to
        # a fresh controller's, which start at zero.
        self._life_base: dict[int, dict[str, Any]] = {}
        # One controller per tenant (``lifecycles``), or the one-tenant
        # plane's single ``lifecycle``.
        self.lifecycle: Any = None
        self.lifecycles: list[Any] | None = None
        self._requests_since_fetch = 0  # collector-thread writer
        self._degraded_base = 0.0  # a dead incarnation's degraded count
        self.slo: Any = None
        self.cost_ledger: Any = None
        # This replica's ``AutotuneController`` (the lead plans, siblings
        # adopt; ``attach_autotune``), mirrored on every telemetry tick.
        self.autotune: Any = None
        self.profiler: Callable[[str], tuple[int, Any]] | None = None
        self._slo_last = 0.0  # telemetry-thread private
        self._prof_handled = 0  # collector-thread private
        # Profile requests the collector took, for ``serve_profile``.
        self._profile_jobs: queue.Queue = queue.Queue()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._collector = threading.Thread(target=self._collect, name="ring-collector",
                                           daemon=True)
        self._collector.start()
        monitor = any(self._accumulating) and self._mon_period > 0
        if monitor or self._tenant_lifecycles() or self._observed():
            self._start_telemetry()

    def _observed(self) -> bool:
        """Any observability mirror armed: the telemetry thread must tick
        for it even with the monitor cadence off."""
        return (self.slo is not None or self.cost_ledger is not None
                or self._shape_stats() is not None)

    def _shape_stats(self):
        """The engines' shared shape histograms (None: tracing off)."""
        return getattr(self.engine, "shape_stats", None)

    def _start_telemetry(self) -> None:
        self._telemetry = threading.Thread(target=self._telemetry_loop,
                                           name="ring-telemetry", daemon=True)
        self._telemetry.start()

    def attach_lifecycle(self, controller: Any) -> None:
        """Mirror the controllers' gauges into the ring on every telemetry
        tick and on ``stop``: one controller (tenant 0) or a list of one
        per tenant. The telemetry thread starts if the monitor cadence did
        not start it."""
        if isinstance(controller, (list, tuple)):
            self.lifecycles = list(controller)
            self.lifecycle = self.lifecycles[0] if self.lifecycles else None
        else:
            self.lifecycle = controller
        self._write_lifecycle()
        if self._telemetry is None and self._collector is not None:
            self._start_telemetry()

    def attach_autotune(self, controller: Any) -> None:
        """Mirror the autotune controller's gauges into this replica's row
        now (the render's MIN fold counts the replica from here on) and on
        every telemetry tick and on ``stop``."""
        self.autotune = controller
        self._write_autotune()
        if self._telemetry is None and self._collector is not None:
            self._start_telemetry()

    def _tenant_lifecycles(self) -> list[tuple[int, Any]]:
        """(tenant index, controller) pairs: the per-tenant list when the
        fleet attached one, else the single controller on tenant row 0."""
        if self.lifecycles is not None:
            return [(t, c) for t, c in enumerate(self.lifecycles) if c is not None]
        return [(0, self.lifecycle)] if self.lifecycle is not None else []

    def stop(self) -> None:
        """Drain: stop collecting, finish the jobs in flight, write the
        final monitor aggregates. Safe to call twice."""
        self._stop.set()
        self.ring.engine_doorbells[self.replica].ring()  # wake the collector
        for thread in (self._collector, self._telemetry):
            if thread is not None:
                thread.join(timeout=10)
        self._pool.shutdown(wait=True)
        self._write_monitors()
        self._write_lifecycle()
        self._write_observability(force=True)
        self._write_autotune()

    # ------------------------------------------------------------ collect
    def _collect(self) -> None:
        ring, rep = self.ring, self.replica
        # Seeded with the entries already queued: their credit may have
        # died with a previous incarnation. Surplus credit after a pop is
        # dropped, never banked.
        credit = int(ring.sub_head[rep]) - int(ring.sub_tail[rep])
        while not self._stop.is_set():
            if rep == 0:
                # /debug/profile: one trace at a time, one seq space, so the
                # lead replica answers it.
                self._handle_profile()
            descs = ring.pop_submissions(limit=credit, replica=rep) if credit else []
            credit = 0
            if not descs:
                credit = ring.engine_doorbells[rep].wait(timeout_s=1.0)
                continue
            if ring.tracing:
                # Stamp 0: the batch left the ring (ring_wait ends).
                now = time.monotonic()
                for slot, _ in descs:
                    ring.resp_trace[slot, 0] = now
            self._requests_since_fetch += len(descs)
            for job in self._make_jobs(descs):
                # Backpressure: the dispatch bound blocks the collector,
                # submissions pile in the ring, front ends run out of
                # slots and shed: bounded end to end.
                self._inflight.acquire()
                self._pool.submit(self._run_job, job)

    def _slot_tenant(self, slot: int) -> int:
        """The slot's tenant tag (the modulo only guards against a garbage
        value indexing out of range: the constructor holds one engine per
        tenant row)."""
        return int(self.ring.slot_tenant[slot]) % len(self.engines)

    def _slot_tier(self, slot: int, tenant: int) -> str | None:
        """The tier the slot's SLO class resolves to on its tenant's engine
        (None: that engine's default tier); a replay resolves the same
        header the same way."""
        route = getattr(self.engines[tenant], "route_tier", None)
        return route(int(self.ring.slot_slo[slot])) if route is not None else None

    def _make_jobs(self, descs: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
        """Small requests group per (tenant, tier), up to ``max_group`` a
        dispatch: a group runs one tenant's program for one tier and folds
        one tenant's accumulator. Everything else runs solo."""
        groupable: dict[tuple[int, str | None], list[tuple[int, int]]] = {}
        solo = []
        for slot, gen in descs:
            tenant = self._slot_tenant(slot)
            grouping = getattr(self.engines[tenant], "supports_grouping", False)
            if grouping and 1 <= int(self.ring.slot_n[slot]) <= GROUP_ROW_BUCKET:
                key = (tenant, self._slot_tier(slot, tenant))
                groupable.setdefault(key, []).append((slot, gen))
            else:
                solo.append((slot, gen))
        jobs = []
        for key in sorted(groupable, key=lambda k: (k[0], k[1] or "")):
            batch = groupable[key]
            jobs += [batch[i:i + self.max_group] for i in range(0, len(batch), self.max_group)]
        return jobs + [[d] for d in solo]

    # ----------------------------------------------------------- reattach
    def reattach(self) -> dict[str, Any]:
        """Run by the replica's engine process after warmup and before
        ``start``, on every boot (a first boot finds nothing to replay):
        bump this replica's incarnation word (its dead incarnation's
        completions become droppable), recover its completion lock, seed
        each tenant's monitor totals, the mirrored counters and the
        lifecycle bases from its rows of shared memory, count the monitor
        rows that died unfetched with the old process, replay every busy
        slot tagged with this replica whose descriptor is not still
        queued, and ring every worker's doorbell with its outstanding
        completion count."""
        # Fault point: delay = a slow re-attach; raise = a failed one (this
        # engine process exits and the supervisor forks another).
        faults.fire("serve.ring.reattach")
        ring, rep = self.ring, self.replica
        eng = ring.eng_vals[rep]
        incarnation = int(eng[ENG_INCARNATION]) + 1
        eng[ENG_INCARNATION] = incarnation
        ring.recover_engine_locks(rep)
        for t in range(ring.tenants):
            if ring.life_vals[t, LIFE_HAS]:
                self._life_base[t] = {
                    "drift_triggers": float(ring.life_vals[t, LIFE_TRIGGERS]),
                    "breaker_trips": float(ring.life_vals[t, LIFE_BREAKER_TRIPS]),
                    "promotions": {outcome: float(ring.life_promos[t, i])
                                   for i, outcome in enumerate(LIFE_OUTCOMES)},
                }
        counts = ring.dispatch_counts(rep)
        self._dispatch_base = {k: float(v) for k, v in counts.items()}
        self._degraded_base = float(eng[ENG_DEGRADED])
        stats = self._shape_stats()
        if stats is not None and float(ring.shape_meta[rep]) > 0:
            # The dead incarnation's histograms, so the exported counters
            # continue instead of resetting.
            stats.seed(_shapes.read_table(ring.shape_keys[rep], ring.shape_vals[rep]),
                       t0=float(ring.shape_meta[rep]))
        self._dispatch_rows = {k: i for i, k in enumerate(counts)}
        self._launch_base = float(ring.kernel_launches[rep])
        for t, engine in enumerate(self.engines):
            mon = ring.mon_vals[rep, t]
            if self._accumulating[t] and mon[MON_HAS]:
                engine.seed_monitor_totals(
                    float(mon[MON_ROWS]), float(mon[MON_OUTLIERS]), float(mon[MON_BATCHES]),
                    np.array(ring.mon_drift_sum[rep, t]), np.array(ring.mon_drift_last[rep, t]),
                )
        pending = ring.pending_submissions(rep)
        # Only this replica's busy slots: a sibling's are its own live work
        # (or its own successor's replay).
        replay = [(slot, int(ring.slot_gen[slot])) for slot in range(ring.n_slots)
                  if int(ring.slot_busy[slot])
                  and int(ring.slot_replica[slot]) % ring.replicas == rep
                  and slot not in pending]
        replay_rows = sum(int(ring.slot_n[slot]) for slot, _ in replay)
        replay_by_tenant: dict[int, int] = {}
        for slot, _ in replay:
            t = self._slot_tenant(slot)
            replay_by_tenant[t] = replay_by_tenant.get(t, 0) + int(ring.slot_n[slot])
        # Per tenant: rows the dead incarnation folded on the device but no
        # fetch preserved, less those the replay folds again, are counted,
        # then the baseline re-anchors to the fetched total so replayed
        # rows land once.
        rows_lost, fetched_total = 0.0, 0.0
        for t in range(ring.tenants):
            if not self._accumulating[t]:
                continue
            mon = ring.mon_vals[rep, t]
            fetched = float(mon[MON_ROWS]) if mon[MON_HAS] else 0.0
            fetched_total += fetched
            rows_lost += max(0.0, float(ring.eng_rows_tenant[rep, t]) - fetched
                             - replay_by_tenant.get(t, 0))
            ring.eng_rows_tenant[rep, t] = fetched
        eng[ENG_ROWS_LOST] += rows_lost
        eng[ENG_ROWS_DISPATCHED] = fetched_total
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
            outstanding = int(ring.comp_head[rep, worker]) - int(ring.comp_tail[rep, worker])
            if outstanding > 0:
                ring.worker_doorbell(worker, rep).ring(outstanding)
        with self._mon_lock:  # warmup's launches too, before the first scrape
            self._mirror_counts()
        return {"incarnation": incarnation, "replayed_slots": len(replay),
                "replay_rows": replay_rows, "monitor_rows_lost": rows_lost}

    # --------------------------------------------------------------- jobs
    def _run_job(self, job: list[tuple[int, int]]) -> None:
        ring, rep = self.ring, self.replica
        try:
            if ring.tracing:
                # Stamp 1: a pool thread owns the job (engine_queue ends).
                now = time.monotonic()
                for slot, _ in job:
                    ring.resp_trace[slot, 1] = now
            # Dead-work shedding: a descriptor whose deadline ran out while
            # it queued completes RESP_EXPIRED without a dispatch.
            now = time.monotonic()
            live, expired = [], []
            for slot, gen in job:
                deadline = float(ring.slot_deadline[slot])
                (expired if deadline and now >= deadline else live).append((slot, gen))
            raws, status = None, RESP_OK
            tenant = self._slot_tenant(job[0][0])
            if live:
                try:
                    raws = self._score(live, tenant)
                # Any scoring failure becomes an error completion on every
                # waiting slot: a dropped descriptor would strand its
                # front end's future until the deadline.
                except Exception:
                    logger.exception("ring dispatch failed (%d slots)", len(live))
                    status = RESP_ERROR
            incarnation = int(ring.eng_vals[rep, ENG_INCARNATION])
            with self._mon_lock:
                ring.eng_vals[rep, ENG_EXPIRED] += len(expired)
                if live and status == RESP_OK and self._accumulating[tenant]:
                    # Folded on the device, not yet preserved by a fetch:
                    # what a death of this process would lose.
                    rows = sum(int(ring.slot_n[s]) for s, _ in live)
                    ring.eng_rows_tenant[rep, tenant] += rows
                    ring.eng_vals[rep, ENG_ROWS_DISPATCHED] += rows
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
                ring.push_completion(slot, gen, rep)
                owner = ring.slot_owner(slot)
                owners[owner] = owners.get(owner, 0) + 1
            for worker, count in owners.items():
                ring.worker_doorbell(worker, rep).ring(count)
        finally:
            self._inflight.release()

    def _score(self, job: list[tuple[int, int]], tenant: int = 0) -> list[tuple[np.ndarray, ...]]:
        """One job -> per-slot raw (predictions, outliers, drift), through
        the job's tenant's engine. Several slots ride one grouped
        dispatch; the arrays arrive encoded, so the engine process does no
        per-record Python."""
        ring, engine = self.ring, self.engines[tenant]
        tier = self._slot_tier(job[0][0], tenant)
        kwargs = {} if tier is None else {"tier": tier}
        parts = []
        for slot, _ in job:
            n = int(ring.slot_n[slot])
            cat, num = ring.request_views(slot)
            parts.append((cat[:n], num[:n]))
        tracing = ring.tracing
        if len(parts) >= 2:
            handle = engine.dispatch_group_arrays(parts, **kwargs)
            if tracing:
                self._stamp_dispatched(job, handle, kind=2)
            sizes, preds, outs, drifts = engine.fetch_group_raw(handle)
            raws = [(preds[i, :n], outs[i, :n], drifts[i]) for i, n in enumerate(sizes)]
        else:
            handle = engine.dispatch_arrays(*parts[0], **kwargs)
            if tracing:
                self._stamp_dispatched(job, handle, kind=1)
            raws = [engine.fetch_arrays_raw(handle)]
        if tracing:
            # Stamp 3: the pinned host buffer is complete (device_fetch
            # ends; the rest is the doorbell and the front end's format).
            now = time.monotonic()
            for slot, _ in job:
                ring.resp_trace[slot, 3] = now
        # Counted under the tier that served: the engine resolves it under
        # its lock, so a job routed to the quant tier just before a
        # promotion to a bundle without one counts on the default tier.
        label = (getattr(handle, "tier", None) or tier
                 or getattr(engine, "default_tier", None))
        with self._mon_lock:
            if label in _TIER_IDX:
                ring.tier_counts[self.replica, _TIER_IDX[label]] += len(job)
            self._mirror_counts()
        if not self._accumulating[tenant]:
            self._fold_host_monitor(raws, tenant)
        return raws

    def _fold_host_monitor(self, raws: list[tuple[np.ndarray, ...]], tenant: int = 0) -> None:
        """The host-side monitor fold of engines without a device
        accumulator (the sklearn host hybrid), into the tenant's shared
        row, as the JAX ring service folds it. The reductions run outside
        the lock."""
        rows = sum(len(pred) for pred, _, _ in raws)
        outliers = float(sum(float(out.sum()) for _, out, _ in raws))
        last = raws[-1][2]
        ring, rep = self.ring, self.replica
        with self._mon_lock:
            ring.mon_vals[rep, tenant, MON_ROWS] += rows
            ring.mon_vals[rep, tenant, MON_OUTLIERS] += outliers
            ring.mon_vals[rep, tenant, MON_BATCHES] += len(raws)
            ring.mon_drift_last[rep, tenant, :] = last
            ring.mon_vals[rep, tenant, MON_HAS] = 1.0

    def _stamp_dispatched(self, job: list[tuple[int, int]], handle: Any, kind: int) -> None:
        """Stamp 2 (the replay and the copy to the host enqueued) and the
        entry that served, from the geometry the handle carries (a
        degraded fallback's included)."""
        rows = int(getattr(handle, "rows", 0))
        geom = int(getattr(handle, "slots", 0)) * 100000 + rows if kind == 2 else rows
        now, trace = time.monotonic(), self.ring.resp_trace
        for slot, _ in job:
            trace[slot, 2] = now
            trace[slot, 4] = float(kind)
            trace[slot, 5] = float(geom)

    # ------------------------------------------------------ /debug/profile
    def _handle_profile(self) -> None:
        """Take a pending profile request word (collector thread). The
        profiler runs on the thread that calls ``serve_profile`` (the
        engine process's main thread, where its CUDA context was made:
        CUPTI starts there), never here: starting ``torch.profiler`` on the
        collector would stall every dispatch behind it."""
        req = int(self.ring.prof_ctl[0])
        seq = req >> 8
        if not seq or seq == self._prof_handled:
            return
        self._prof_handled = seq
        action = {v: k for k, v in PROFILE_ACTIONS.items()}.get(req & 0xFF)
        if self.profiler is None or action is None:
            self._ack_profile(seq, 404)
        else:
            self._profile_jobs.put((seq, action))

    def serve_profile(self, timeout_s: float) -> None:
        """Run one pending ``/debug/profile`` request on the calling thread,
        waiting up to ``timeout_s`` for one."""
        try:
            seq, action = self._profile_jobs.get(timeout=max(timeout_s, 0.0))
        except queue.Empty:
            return
        self._run_profile(seq, action)

    def _run_profile(self, seq: int, action: str) -> None:
        try:
            status = int(self.profiler(action)[0])
        # The profiler logs and answers its own failures with 500; this
        # catches a failure around it, answered 500 too, never a lost ack.
        except Exception:
            logger.exception("ring profile %s failed", action)
            status = 500
        self._ack_profile(seq, status)

    def _ack_profile(self, seq: int, status: int) -> None:
        # Never regress the answer word: a late answer to an abandoned seq
        # must not mask a newer one.
        if seq >= int(self.ring.prof_ctl[1]) >> 16:
            self.ring.prof_ctl[1] = (seq << 16) | (status & 0xFFFF)

    def _mirror_counts(self) -> None:
        """Publish this replica's dispatches per program, summed over its
        tenant engines, and the kernel's launches (plus the respawn
        bases); caller holds ``_mon_lock``, so the writes never go back in
        time."""
        ring, rep = self.ring, self.replica
        counts: dict[str, int] = {}
        for engine in self.engines:
            for label, n in getattr(engine, "dispatch_counts", dict)().items():
                counts[label] = counts.get(label, 0) + n
        for label in {*counts, *self._dispatch_base}:
            row = self._dispatch_rows.get(label)
            if row is None:
                row = len(self._dispatch_rows)
                if row >= DISPATCH_ROWS:
                    continue
                self._dispatch_rows[label] = row
                key = label.encode()[:DISPATCH_KEY_BYTES]
                ring.disp_keys[rep, row] = 0
                ring.disp_keys[rep, row, :len(key)] = np.frombuffer(key, np.uint8)
            ring.disp_vals[rep, row] = self._dispatch_base.get(label, 0.0) + counts.get(label, 0)
        ring.kernel_launches[rep] = self._launch_base + self._kernel_launches()

    # ----------------------------------------------------------- telemetry
    def _telemetry_loop(self) -> None:
        """Single-flight monitor reads, in the engine process only: after
        K ring requests, or when the period lapses with traffic
        outstanding (and once at start); never per request or scrape.
        Every tick also mirrors the lifecycle controllers' gauges."""
        monitor = any(self._accumulating) and self._mon_period > 0
        tick = min(0.25, self._mon_period) if monitor else 0.25
        last = time.monotonic()
        while not self._stop.wait(tick):
            self._write_lifecycle()
            self._write_observability()
            self._write_autotune()
            if not monitor:
                continue
            never = any(self._accumulating[t] and not self.ring.mon_vals[self.replica, t, MON_HAS]
                        for t in range(len(self.engines)))
            due = (
                (self._mon_every and self._requests_since_fetch >= self._mon_every)
                or (time.monotonic() - last >= self._mon_period
                    and self._requests_since_fetch > 0)
                or never
            )
            if not due:
                continue
            self._requests_since_fetch = 0
            last = time.monotonic()
            self._write_monitors()

    def _write_observability(self, force: bool = False) -> None:
        """Mirror the degraded count, the shape histograms and the cost
        ledger into this replica's rows, and on the lead replica tick the
        SLO engine (at its own cadence; ``force`` on drain) into the SLO
        rows: host reads and f64 stores, no device work."""
        ring, rep = self.ring, self.replica
        degraded = sum(getattr(e, "degraded_dispatch_total", 0) for e in self.engines)
        with self._mon_lock:
            ring.eng_vals[rep, ENG_DEGRADED] = self._degraded_base + float(degraded)
        stats = self._shape_stats()
        if stats is not None:
            stats.write_table(ring.shape_keys[rep], ring.shape_vals[rep])
            ring.shape_meta[rep] = stats.t0
            # max(): a respawned incarnation's fresh count never regresses it.
            ring.shape_evicted[rep] = max(float(ring.shape_evicted[rep]),
                                          float(stats.evicted_total))
        if self.cost_ledger is not None:
            self.cost_ledger.write_table(ring.ledger_keys[rep], ring.ledger_vals[rep])
            ring.ledger_meta[rep] = 1.0
        slo = self.slo
        if slo is not None and rep == 0:
            now = time.monotonic()
            if force or now - self._slo_last >= float(slo.config.tick_s):
                self._slo_last = now
                try:
                    slo.tick()
                    slo.write_rows(ring.slo_vals, ring.alert_vals)
                # An evaluator failure costs one tick of freshness, logged,
                # never the telemetry thread.
                except Exception:
                    logger.exception("slo tick failed; alert gauges stale")

    def _write_autotune(self) -> None:
        """Mirror the attached autotune controller's snapshot into this
        replica's row (host reads and f64 stores, no device work)."""
        controller = self.autotune
        if controller is None:
            return
        try:
            self.ring.write_autotune(controller.metrics_snapshot(), self.replica)
        # A controller mid-regrid costs one gauge refresh, never the
        # telemetry thread.
        except Exception:
            logger.exception("ring autotune write failed; gauges stale")

    def _write_monitors(self) -> None:
        """Each accumulating tenant engine's snapshot into its row; one
        tenant's failed fetch keeps its last gauges and never stops the
        others' (the next tick retries)."""
        for t, engine in enumerate(self.engines):
            if not self._accumulating[t]:
                continue
            try:
                self.ring.write_monitor(engine.monitor_snapshot(), t, self.replica)
            except Exception:
                logger.exception("ring monitor fetch failed (tenant %d); gauges stale", t)

    def _write_lifecycle(self) -> None:
        """Mirror each controller's gauge snapshot, plus the dead
        incarnations' bases, into its tenant's row (host reads and f64
        stores, no device work)."""
        for tenant, controller in self._tenant_lifecycles():
            try:
                snapshot = controller.metrics_snapshot()
                base = self._life_base.get(tenant)
                if base and snapshot:
                    snapshot = dict(snapshot)
                    for key in ("drift_triggers", "breaker_trips"):
                        snapshot[key] = snapshot.get(key, 0) + base[key]
                    promotions = dict(snapshot.get("promotions", {}))
                    for outcome, count in base["promotions"].items():
                        promotions[outcome] = promotions.get(outcome, 0) + count
                    snapshot["promotions"] = promotions
                self.ring.write_lifecycle(snapshot, tenant)
            # A controller mid-transition costs one gauge refresh, never
            # the telemetry thread.
            except Exception:
                logger.exception("ring lifecycle write failed (tenant %d); gauges stale",
                                 tenant)
