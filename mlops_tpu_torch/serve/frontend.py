"""The multi-worker ring plane: ``SO_REUSEPORT`` front ends + E engine
replicas, serving a tenant fleet.

The port's copy of the JAX package's ``serve/frontend.py``. ``serve
--workers N`` (``serve.workers`` >= 2, ``MLOPS_TPU_SERVE_WORKERS``)
replaces the single-process server with N front-end processes that each
bind the same host:port through ``SO_REUSEPORT``: the kernel spreads
accepted connections over them, so HTTP parsing, validation, encoding and
response formatting run on N cores, all feeding the engine processes over
the shared-memory ring (``serve/ipc.py``). ``serve --replicas E``
(``serve.engine_replicas``) runs E engine replica processes behind that
one ring; each front end routes every submit through its
``ReplicaRouter`` (least-loaded, small-class tenant affinity). ``serve
--tenants <file>`` (``serve.tenants_path``) serves the fleet of a
tenants.toml: every replica process holds one engine per tenant
(``tenancy.TenantRegistry``), each front end one preprocessor per tenant
and, for more than one tenant, one weighted max-min ``QuotaGovernor`` per
slot class (a hot tenant sheds 503 against its own quota).

Process model: the parent is a supervisor without threads and without
torch. It builds the ring, reserves the port and forks every other
process: the N front ends and the E engine children, which import torch
and touch the card only after the fork, so no fork ever crosses a thread
or a CUDA context (each fork checks it). Replica 0 starts first and the
others once it is ready: on a cold kernel cache replica 0 runs nvcc and
the rest load its libraries. On one visible card every replica shares
it (the card time-slices their kernels); replica r takes card r only
when the process sees a card per replica. Respawns fork from the same
clean supervisor. A crashed front end is respawned and re-attaches to its
slot partition through the generation counters. A dead replica is a
brownout of 1/E of capacity: the router routes new admissions to the
others, and the supervisor forks a replacement, which loads its kernels
from ``cache.dir`` (no nvcc), captures its graphs, re-attaches under a
new incarnation of its own and replays the busy slots routed to it
(``RingService.reattach``). Only with every replica down do admissions
park against their deadline budgets (200 when the replay lands in time,
504 past the budget) until the partition fills; then the shed 503's
Retry-After advertises the respawn ETA. More than five deaths of one
replica in 60 s is a crash loop: the supervisor drains and exits 1.

Load shedding: each front end's slot partition is its bounded admission
queue per slot class. No free slot answers ``503`` with Retry-After at
once; with ``serve.tier_routing`` the brownout governor first demotes
default-class requests to the cheaper tier as the partition fills. On a
multi-tenant plane the quota check comes first, per slot class.

The lifecycle loops (``lifecycle.enabled=true``) run engine-side, in
replica 0, one ``LifecycleController`` per tenant (each on its own state
directory; a one-tenant ``default`` fleet keeps ``lifecycle.dir``): the
front ends encode with the fork-time preprocessors, so a refit is forced
off, and the ring's telemetry thread mirrors each controller's gauges
into its tenant's row for every front end's ``/metrics``. A respawned
engine serves the fork-time bundles again at generation 1, as the JAX
plane does, restarts the loops from the on-disk reservoirs, and carries
the dead incarnation's lifecycle counters as bases. A replica set with
the loop is refused (one controller hot-swaps one process's bundle).

Graceful drain: SIGTERM to the supervisor reaches every front end; each
stops accepting, finishes its in-flight exchanges (the engines keep
answering meanwhile) and exits; then the supervisor stops the engine
replicas, which stop their lifecycle loops, finish their jobs and write
their last monitor aggregates and lifecycle gauges.

Observability (``trace.enabled``, ``slo.enabled``, ``slo.ledger_dir``),
as the JAX plane wires it: the supervisor creates ``trace.dir``, flips the
ring's tracing word and publishes the SLO geometry before it forks. Each
front end keeps its own span recorder (``<trace.dir>/spans-w<N>.jsonl``;
drops counted in the ring) and stitches the engine half of every traced
request from its slot; with SLOs armed it keeps its own flight recorder,
which dumps on an alert turning on, an engine respawn, a 5xx spike or a
SIGTERM with evidence, and answers ``/healthz`` from the SLO rows. Each
engine replica feeds one ``ShapeStats`` (tracing) and one ``CostLedger``
(``slo.ledger_dir``, ``ledger-r<k>.json`` per replica of a set); replica 0
runs the ``SLOEngine`` over the ring's counters and answers
``/debug/profile`` (with ``serve.profile_dir``), which the front ends
forward over the ring.

The autotuner (``autotune.enabled``, which needs tracing and the ledger):
every engine replica starts an ``AutotuneController`` after its warmup.
Replica 0 fits, searches, regrids and persists the plan
(``<autotune.plan_dir>/plan.json``); every other replica adopts it on a
later tick, capturing its own graphs (CUDA graphs do not cross processes;
the kernel cache does). Each replica mirrors its controller into its
autotune row, and ``mlops_tpu_grid_generation`` renders the MIN over the
replicas.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import math
import multiprocessing
import os
import signal
import socket
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable

from mlops_tpu_torch import faults
from mlops_tpu_torch.config import Config, ServeConfig
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.httpcore import HttpProtocol, _LazyJson
from mlops_tpu_torch.serve.ipc import (
    RequestRing,
    RingClient,
    RingService,
    ShmWorkerMetrics,
)
from mlops_tpu_torch.serve.ipc import PROFILE_ACTIONS
from mlops_tpu_torch.serve.metrics import (
    ENG_DOWN_SINCE,
    ENG_RESPAWNS,
    render_ring_metrics,
)
from mlops_tpu_torch.serve.tierroute import BrownoutGovernor
from mlops_tpu_torch.serve.wire import (
    EMPTY_RESPONSE_BYTES,
    RESP_EXPIRED,
    RESP_OK,
    deadline_response,
    encode_response,
    profile_payload,
)
from mlops_tpu_torch.tenancy.config import (
    TenancyConfig,
    load_tenants_toml,
    single_tenant_config,
)
from mlops_tpu_torch.tenancy.quota import QuotaGovernor
from mlops_tpu_torch.tenancy.router import TenantRouter

logger = logging.getLogger("mlops_tpu_torch.serve")

# More deaths of one replica than this inside the window is a crash loop,
# not a blip: the supervisor drains and exits 1 for the orchestrator.
_ENGINE_STORM_DEATHS = 5
_ENGINE_STORM_WINDOW_S = 60.0
_SUPERVISE_TICK_S = 0.25
# How long a front end waits for the engine's answer to a forwarded
# /debug/profile request before cancelling it and answering 504.
_PROFILE_ACK_S = 10.0


# tpulint Layer-5 manifest: each front-end process is one asyncio loop;
# FrontendServer's mutable state and the ring client's doorbell path are
# EVENT-LOOP CONFINED: blocking work (encode, flight-recorder dumps,
# anomaly scans) goes through run_in_executor, never the loop thread.
TPULINT_LOOP_CONFINED = ("FrontendServer", "RingClient.on_doorbell")


def reuseport_socket(host: str, port: int) -> socket.socket:
    """A bound (not listening) TCP socket with ``SO_REUSEPORT``: every
    front end binds its own and the kernel spreads connections over the
    listening ones. The supervisor binds one too, never listening, to pin
    the port (port 0 resolves once)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    return sock


class FrontendServer(HttpProtocol):
    """The ring-backed front end: the shared HTTP protocol and
    ``/predict`` shell, with the engine call replaced by quota -> claim a
    slot -> encode into its slab -> await the completion doorbell ->
    encode the raw response arrays with the single-process plane's wire
    formatter, so answers are byte-identical to it. ``preprocessor`` is
    one per tenant (a single one is the one-tenant fleet)."""

    def __init__(self, config: ServeConfig, ring: RequestRing, worker_id: int,
                 preprocessor: Any, tenancy: TenancyConfig | None = None,
                 trace: Any = None, slo: Any = None) -> None:
        super().__init__(config)
        self.ring = ring
        self.worker_id = worker_id
        self.preprocessors = (list(preprocessor) if isinstance(preprocessor, (list, tuple))
                              else [preprocessor])
        if len(self.preprocessors) != ring.tenants:
            raise ValueError(f"{len(self.preprocessors)} preprocessors for "
                             f"{ring.tenants} ring tenants")
        default_index = tenancy.default_index if tenancy is not None else 0
        weights = tenancy.weights if tenancy is not None else (1.0,) * ring.tenants
        self.tenants = TenantRouter(ring.tenant_names, default_index)
        # One governor per slot class over this worker's partition (the
        # classes are separate physical pools, so fairness holds in each);
        # a one-tenant fleet needs none. Confined to the event loop.
        self.quota = ((QuotaGovernor(ring.slots_small, weights),
                       QuotaGovernor(ring.slots_large, weights))
                      if ring.tenants > 1 else None)
        self.client = RingClient(ring, worker_id,
                                 affinity_slack=config.replica_affinity_slack)
        self.metrics = ShmWorkerMetrics(ring, worker_id, default_tenant=default_index)
        self.trace_plane = "ring"
        self.trace_worker = worker_id
        if trace is not None and trace.enabled:
            from mlops_tpu_torch.trace import TraceRecorder

            def _count_drops(n: int) -> None:
                ring.trace_dropped[worker_id] += n

            # A file per worker: appends never need coordinating.
            self.tracer = TraceRecorder(
                Path(trace.dir) / f"spans-w{worker_id}.jsonl",
                capacity=trace.ring_capacity,
                flush_interval_s=trace.flush_interval_s,
                on_drop=_count_drops,
            )
        if slo is not None and slo.enabled and slo.flightrec_enabled:
            from mlops_tpu_torch.slo import FlightRecorder

            def _count_dump(path) -> None:
                ring.flight_dumps[worker_id] += 1

            # This worker's own evidence ring; the SLO engine runs in the
            # lead engine replica, whose alert rows the watchdog reads.
            self.flightrec = FlightRecorder(
                slo.flightrec_dir,
                capacity=slo.flightrec_capacity,
                cooldown_s=slo.flightrec_cooldown_s,
                keep=slo.flightrec_keep,
                source="ring",
                worker=worker_id,
                spike_errors=slo.flightrec_spike_errors,
                spike_window_s=slo.flightrec_spike_window_s,
                on_dump=_count_dump,
            )
        # The large slabs are sized to the (bucket-clamped) request cap.
        self.max_batch = min(config.max_batch, ring.large_rows)
        # SLO tier routing is armed by the config, as the JAX front end
        # arms it: the class rides the slot header and each tenant's engine
        # resolves it to a tier it holds (its default when it holds no
        # other). Demote before shed, per worker, fed by this worker's
        # partition occupancy: the resource whose exhaustion sheds.
        self.slo_routing = bool(config.tier_routing)
        self._brownout = (
            BrownoutGovernor(demote_depth=config.brownout_demote_depth,
                             restore_depth=config.brownout_restore_depth)
            if self.slo_routing else None
        )

    def _ready(self) -> bool:
        return self.ring.engine_ready and not self.draining

    def _outage(self) -> bool:
        """The supervisor stamped a replica's death and no replica is up:
        a full outage, not a first boot still warming and not the partial
        brownout the router absorbs."""
        return (not self.ring.engine_ready
                and bool((self.ring.eng_vals[:, ENG_DOWN_SINCE] > 0).any()))

    def _respawn_retry_after(self) -> int:
        """Retry-After of a brownout 503: the respawn ETA less the time
        since the earliest still-down replica died, the full ETA again once
        that is blown, never under 1 s."""
        eta = self.config.engine_respawn_eta_s
        stamps = [float(v) for v in self.ring.eng_vals[:, ENG_DOWN_SINCE] if v > 0]
        remaining = eta - (time.monotonic() - min(stamps)) if stamps else eta
        return max(1, math.ceil(remaining if remaining > 0 else eta))

    def _slo_view(self):
        """The fleet view the lead replica last mirrored (rows never
        written read as the zero baseline); None with SLOs disarmed."""
        if not self.ring.slo_armed:
            return None
        from mlops_tpu_torch.slo.engine import read_slo_view

        return read_slo_view(self.ring.slo_vals, self.ring.alert_vals,
                             self.ring.tenant_names,
                             tuple(float(x) for x in self.ring.slo_meta[:4]))

    def _engine_down(self) -> bool:
        return self._outage()

    async def _metrics_endpoint(self):
        # Every series renders from shared memory: any worker answers a
        # scrape with the whole plane, which SO_REUSEPORT requires.
        return 200, render_ring_metrics(self.ring), "text/plain; version=0.0.4"

    async def _profile(self, action: str):
        """Forward ``/debug/profile`` to engine replica 0, which holds the
        card: claim the channel (busy: 409), post the request word, wait
        for the answer word (10 s, then cancel: 504) and answer with the
        single-process plane's payloads."""
        if not self.config.profile_dir:
            return profile_payload(404, action, "")
        code = PROFILE_ACTIONS.get(action)
        if code is None:
            return 404, {"detail": "not found"}, "application/json"
        ring = self.ring
        token = ring.try_claim_profile()
        if token is None:
            return 409, {"detail": "profile control busy"}, "application/json"
        loop = asyncio.get_running_loop()
        try:
            seq = ring.post_profile_request(code)
            deadline = loop.time() + _PROFILE_ACK_S
            while (status := ring.read_profile_ack(seq)) is None:
                if loop.time() >= deadline:
                    ring.cancel_profile_request(seq, token)
                    status = 504
                    break
                await asyncio.sleep(0.02)
        finally:
            ring.release_profile(token)
        return profile_payload(status, action, self.config.profile_dir)

    def _stitch_engine_half(self, span, slot: int) -> None:
        """Fold the engine's stamps from the slot into ``span`` (between
        completion and release: the response slab's ownership window). A
        slot without all four (the engine ran untraced) keeps the front
        end's stamps only."""
        stamps = self.ring.resp_trace[slot]
        collect, jobstart, dispatched, fetched = (float(x) for x in stamps[:4])
        if not (collect and jobstart and dispatched and fetched):
            return
        span.stamp_at("ring_wait", collect)
        span.stamp_at("engine_queue", jobstart)
        span.stamp_at("dispatch", dispatched)
        span.stamp_at("device_fetch", fetched)
        span.replica = int(self.ring.slot_replica[slot]) % self.ring.replicas
        kind, geom = int(stamps[4]), int(stamps[5])
        if kind == 1:
            span.entry = f"bucket_{geom}"
        elif kind == 2:
            span.entry = f"group_{geom // 100000}x{geom % 100000}"

    def close_tracer(self) -> None:
        """Flush this worker's span file (the drain path, once the
        exchanges in flight finished)."""
        if self.tracer is not None:
            self.tracer.close()

    def _shed(self, n: int, tenant: int) -> tuple:
        """The 503 of a full partition: Retry-After as configured, or the
        respawn ETA while every replica is down (a brownout shed)."""
        self.client.count_shed(n, tenant)
        cls = "small" if n <= self.ring.small_rows else "large"
        if self._outage():
            self.ring.brownout_shed[self.worker_id] += 1
            retry_s = self._respawn_retry_after()
            detail = (f"engine restarting and parking is full (no free {cls} "
                      f"request slot); retry in {retry_s}s")
        else:
            retry_s = self.config.shed_retry_after_s
            detail = f"overloaded: no free {cls} request slot; retry in {retry_s}s"
        return 503, {"detail": detail}, "application/json", {"retry-after": str(retry_s)}

    async def _score(self, records: list[dict], request_id: str,
                     deadline: float | None, slo: int, tenant: int = 0, span=None):
        """The tenant's quota first, in the slot class the row count names
        (a one-tenant plane has none), then the slot round trip."""
        if not records:
            return EMPTY_RESPONSE_BYTES
        if self.quota is None:
            return await self._score_admitted(records, request_id, deadline, slo, tenant,
                                              span)
        governor = self.quota[0 if len(records) <= self.ring.small_rows else 1]
        verdict = governor.try_acquire(tenant)
        if verdict == "quota":
            # Capacity exists, the tenant's share does not cover it: a 503
            # against its own quota, counted per tenant (not a slot shed).
            self.client.count_quota_shed(tenant)
            retry_s = self.config.shed_retry_after_s
            name = self.tenants.names[tenant]
            return (503, {"detail": f"tenant {name!r} over quota; retry in {retry_s}s"},
                    "application/json", {"retry-after": str(retry_s)})
        if verdict == "full":
            # No hold to release: the claim answers the physical shed.
            return await self._score_admitted(records, request_id, deadline, slo, tenant,
                                              span)
        try:
            return await self._score_admitted(records, request_id, deadline, slo, tenant,
                                              span)
        finally:
            # The governor holds admitted requests, not slots: a zombie
            # slot awaiting a late completion keeps its slot, never its
            # quota.
            governor.release(tenant)

    async def _score_admitted(self, records: list[dict], request_id: str,
                              deadline: float | None, slo: int, tenant: int, span=None):
        """Slot admission before encode (a shed costs nothing), encode
        into the slab with the tenant's preprocessor, then the slot's round
        trip. The deadline budget rides the slot header, so the engine
        completes an expired descriptor unscored, and bounds the
        completion wait."""
        # Fault point: kill = a front end's crash mid-request (the
        # supervisor's respawn and the slot quarantine).
        faults.fire("serve.frontend.predict")
        n = len(records)
        demoted = False
        if self._brownout is not None:
            self._brownout.observe(self.client.pressure())
            slo, demoted = self._brownout.route(slo)
        slot = self.client.claim(n, slo, tenant=tenant, allow_overflow=self.quota is None)
        if slot is None:
            return self._shed(n, tenant)
        if demoted:  # counted for admitted requests only
            self.client.count_demotion(brownout=True)
        submitted = False
        try:
            loop = asyncio.get_running_loop()
            if deadline is not None and loop.time() >= deadline:
                self.client.release(slot)
                slot = None
                self.metrics.count_deadline_expired()
                return deadline_response()
            ds = self.preprocessors[tenant].encode(records_to_columns(records))
            if span is not None:
                span.stamp("encode")
            future = self.client.submit(slot, ds.cat_ids, ds.numeric, deadline=deadline)
            submitted = True
            timeout = self.config.request_timeout_s or None
            if deadline is not None:
                remaining = deadline - loop.time()
                timeout = min(timeout or remaining, remaining)
            # Parked: admitted while every replica is down; a respawned
            # replica's replay answers it, or its deadline does.
            parked = self._outage()
            if parked:
                self.ring.parked[self.worker_id] += 1
            try:
                if timeout is not None:
                    status = await asyncio.wait_for(future, max(timeout, 0.0))
                else:
                    status = await future
            except asyncio.TimeoutError:
                logger.error("prediction deadline (%.1fs) exceeded request_id=%s — "
                             "engine stall?", timeout, request_id)
                self.client.abandon(slot)
                slot = None
                return deadline_response(f"prediction exceeded the {timeout:g}s deadline")
            finally:
                if parked:
                    self.ring.parked[self.worker_id] -= 1
            if status != RESP_OK:
                # An expired descriptor (counted engine-side) or a failed
                # dispatch (logged by the engine); the completion proves
                # the slab quiescent.
                self.client.release(slot)
                slot = None
                if status == RESP_EXPIRED:
                    return deadline_response()
                return 500, {"detail": "prediction failed"}, "application/json"
            if span is not None:
                self._stitch_engine_half(span, slot)
            # The encode reads every float, so the slab is free after it.
            response = encode_response(*self.client.response_arrays(slot))
            self.client.release(slot)
            slot = None
            return response
        # Request boundary: any failure is a logged 500, never a dropped
        # connection or a leaked slot.
        except Exception:  # tpulint: disable=TPU201
            logger.exception("prediction failed request_id=%s", request_id)
            if slot is not None:
                (self.client.abandon if submitted else self.client.release)(slot)
            return 500, {"detail": "prediction failed"}, "application/json"

    async def start(self) -> asyncio.AbstractServer:
        """Bind this worker's own socket and hook every replica's
        completion doorbell into the event loop."""
        sock = reuseport_socket(self.config.host, self.config.port)
        loop = asyncio.get_running_loop()
        for replica in range(self.ring.replicas):
            loop.add_reader(self.ring.worker_doorbell(self.worker_id, replica).fileno(),
                            self.client.on_doorbell, replica)
            # One kick per replica: a respawned client may hold credit for
            # completions whose doorbell its dead incarnation drained.
            loop.call_soon(self.client.on_doorbell, replica)
        return await asyncio.start_server(self.handle_connection, sock=sock)

    def stop_doorbell(self) -> None:
        for replica in range(self.ring.replicas):
            with contextlib.suppress(Exception):
                asyncio.get_running_loop().remove_reader(
                    self.ring.worker_doorbell(self.worker_id, replica).fileno())


# --------------------------------------------------------------- children
def _frontend_main(worker_id: int, config: ServeConfig, ring: RequestRing,
                   preprocess_paths: list[str], tenancy: TenancyConfig | None,
                   trace: Any = None, slo: Any = None) -> None:
    """A front-end process (forked; everything arrives by inheritance).
    It never imports torch and never touches the device."""
    from mlops_tpu_torch.data.encode import Preprocessor

    preprocessors = [Preprocessor.load(path) for path in preprocess_paths]
    with contextlib.suppress(KeyboardInterrupt):
        asyncio.run(_run_frontend(worker_id, config, ring, preprocessors, tenancy,
                                  trace, slo))


async def _run_frontend(worker_id: int, config: ServeConfig, ring: RequestRing,
                        preprocessors: list, tenancy: TenancyConfig | None,
                        trace: Any = None, slo: Any = None) -> None:
    server = FrontendServer(config, ring, worker_id, preprocessors, tenancy,
                            trace=trace, slo=slo)
    srv = await server.start()
    logger.info("frontend %d serving %s on %s:%s (pid %d)", worker_id,
                config.service_name, config.host, config.port, os.getpid())
    loop = asyncio.get_running_loop()
    if config.loop_lag_monitor:
        # The runtime half of the Layer-5 discipline, per worker: the
        # watchdog drains each window max into this worker's shm cell, so
        # any worker's scrape renders every front end's lag.
        from mlops_tpu_torch.analysis.loopcheck import LoopLagSanitizer

        server.loop_monitor = LoopLagSanitizer(slow_ms=config.loop_lag_slow_ms)
        server.loop_monitor.attach(loop)
        logger.info("frontend %d: loop-lag sanitizer armed (slow_ms=%g)",
                    worker_id, config.loop_lag_slow_ms)
    draining = asyncio.Event()

    def _drain() -> None:
        draining.set()
        server.begin_drain(srv)

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, _drain)
    parent = os.getppid()

    def _alert_flags() -> dict:
        from mlops_tpu_torch.slo.engine import ENGINE_ALERTS

        return {(alert, tenant): bool(ring.alert_vals[t, a])
                for a, alert in enumerate(ENGINE_ALERTS)
                for t, tenant in enumerate(ring.tenant_names)}

    def _watch_anomalies(state: dict) -> None:
        # The flight recorder's triggers this worker sees only in shared
        # memory: a respawn the supervisor counted, an alert flag turning
        # on. Edge-detected against the previous pass, so a sustained
        # alert dumps once (and the recorder's cooldown bounds the rest).
        from mlops_tpu_torch.slo.engine import ALERT_SEVERITY

        respawns = int(ring.eng_vals[:, ENG_RESPAWNS].sum())
        if respawns > state["respawns"]:
            server.flightrec.trigger("engine_respawn")
        state["respawns"] = respawns
        flags = _alert_flags()
        for (alert, tenant), active in flags.items():
            if active and not state["alerts"].get((alert, tenant)):
                server.flightrec.note_alert(alert, tenant, ALERT_SEVERITY[alert])
        state["alerts"] = flags

    async def _watch() -> None:
        # Besides SIGTERM: the ring's drain flag, or a dead supervisor
        # (nobody could respawn this worker). Engine death is no reason to
        # drain: the supervisor respawns it and requests park meanwhile.
        # The anomaly state starts from the present: a worker (re)spawned
        # mid-incident never dumps for history it did not see.
        anomalies = {"respawns": int(ring.eng_vals[:, ENG_RESPAWNS].sum()),
                     "alerts": _alert_flags() if ring.slo_armed else {}}
        while not draining.is_set():
            await asyncio.sleep(0.5)
            if server.loop_monitor is not None:
                # This worker's worst callback over the last watchdog
                # window, into its own cell (0.0: the loop stayed smooth).
                server.metrics.set_loop_lag(server.loop_monitor.snapshot_ms())
            if server.flightrec is not None:
                # A triggered dump writes a file: off the event loop.
                await loop.run_in_executor(None, _watch_anomalies, anomalies)
            if ring.draining or os.getppid() != parent:
                logger.info("frontend %d: %s; draining", worker_id,
                            "ring drain flag set" if ring.draining else "supervisor gone")
                _drain()

    watchdog = asyncio.create_task(_watch())
    await draining.wait()
    # Busy exchanges and in-flight slots get the drain window.
    deadline = loop.time() + config.drain_deadline_s
    while (server._busy or server.client.pending_count()) and loop.time() < deadline:
        await asyncio.sleep(0.05)
    for writer in list(server._connections):
        writer.close()
    server.stop_doorbell()
    watchdog.cancel()
    with contextlib.suppress(asyncio.TimeoutError):
        await asyncio.wait_for(srv.wait_closed(), timeout=5)
    # After the exchanges finished: every span is recorded, and the final
    # flush writes whole lines only.
    await loop.run_in_executor(None, server.close_tracer)
    if server.flightrec is not None:
        # A clean drain writes nothing; one during an incident keeps the
        # evidence.
        await loop.run_in_executor(None, server.flightrec.dump_if_evidence, "sigterm")
    if server.loop_monitor is not None:
        server.loop_monitor.detach()
        server.loop_monitor = None
    logger.info("frontend %d drained; exiting", worker_id)


def build_engine(config: Config, bundle_dir: str, mesh=None):
    """One tenant's engine in a replica process: the bundle on
    ``serve.device`` (the card unless ``cpu``), as the single-process
    ``serve`` builds it, over the replica's ('model',) ``mesh`` when
    ``serve.model_shards > 1``."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    cfg = config.serve
    return InferenceEngine(load_bundle(bundle_dir), buckets=tuple(cfg.warmup_batch_sizes),
                           serve_tier=cfg.serve_tier, device=cfg.device,
                           tier_routing=cfg.tier_routing, mesh=mesh)


def _replica_config(config: Config, replica: int, replicas: int) -> Config:
    """The config a replica process builds its engines with. Sharded
    (``serve.model_shards = S > 1``), replica r is S ranks on cards
    ``[r*S, (r+1)*S)`` (its lead on card ``r*S``), as the JAX plane takes
    a device slice per replica, and a process that sees fewer than
    ``replicas * S`` cards is refused, naming the count. Unsharded, on one
    visible card (or too few for one each) every replica shares
    ``serve.device``; replica r takes card r only when the process sees a
    card per replica."""
    if config.serve.device != "cuda":
        return config
    import torch

    visible = torch.cuda.device_count()
    shards = config.serve.model_shards
    if shards > 1:
        if visible < replicas * shards:
            raise ValueError(
                f"serve.model_shards={shards} with {replicas} engine replica(s) "
                f"needs {replicas * shards} cards (replica r on cards [r*S, (r+1)*S)); "
                f"this process sees {visible}"
            )
        first = replica * shards
        logger.info("engine replica %d pinned to cards [%d, %d)", replica, first,
                    first + shards)
        return dataclasses.replace(
            config, serve=dataclasses.replace(config.serve, device=f"cuda:{first}"))
    if replicas < 2 or visible < replicas:
        return config
    logger.info("engine replica %d pinned to cuda:%d", replica, replica)
    return dataclasses.replace(
        config, serve=dataclasses.replace(config.serve, device=f"cuda:{replica}"))


def _engine_main(config: Config, ring: RequestRing, tenancy: TenancyConfig,
                 make_engine: Callable, replica: int = 0) -> None:
    """An engine replica process (forked from the supervisor; torch is
    imported here, after the fork): load the kernels from ``cache.dir``,
    build and warm one engine per tenant (``TenantRegistry``), re-attach
    to the ring as ``replica`` (replaying what a dead predecessor left
    busy, each slot under its tenant), start the lifecycle loops when they
    are enabled, serve until SIGTERM or the supervisor's death. First boot
    and every respawn run this same function."""
    t0 = time.monotonic()
    stop: list[int] = []  # a signal handler appends; the main loop polls
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    from mlops_tpu_torch.ops import cuda_build
    from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
    from mlops_tpu_torch.tenancy.registry import TenantRegistry

    t_import = time.monotonic()
    cuda_build.set_cache_dir(config.cache.dir)
    serve_cfg = config.serve
    scoped = _replica_config(config, replica, ring.replicas)
    mesh = followers = None
    if serve_cfg.model_shards > 1:
        # This process is the replica's lead, rank 0 of its S ranks; the
        # followers build each engine as it announces it. A follower's
        # death ends this process, and the supervisor respawns the replica.
        import torch

        from mlops_tpu_torch.serve.shards import start_followers

        lead = torch.device(scoped.serve.device)
        mesh, followers, _ = start_followers(serve_cfg.model_shards, lead.type,
                                             offset=lead.index or 0)
        registry = TenantRegistry(
            tenancy, make_engine=lambda path: make_engine(scoped, path, mesh=mesh))
    else:
        registry = TenantRegistry(tenancy,
                                  make_engine=lambda path: make_engine(scoped, path))
    engines = registry.engines
    if ring.tracing:
        from mlops_tpu_torch.trace import ShapeStats

        # One ShapeStats for the fleet: entries key by compiled shape,
        # which every tenant's engine warms alike.
        stats = ShapeStats()
        for engine in engines:
            engine.set_shape_stats(stats)
    slo_cfg = config.slo
    ledger = None
    if slo_cfg.ledger_dir:
        from mlops_tpu_torch.slo import CostLedger

        # One per replica process, a file each on a replica set, so
        # concurrent flushes never clobber a sibling's totals; a respawn
        # continues from its file.
        ledger = CostLedger(slo_cfg.ledger_dir, flush_interval_s=slo_cfg.ledger_flush_s,
                            shard=f"r{replica}" if ring.replicas > 1 else "")
        for engine in engines:
            engine.set_cost_ledger(ledger)
        logger.info("cost ledger armed -> %s", ledger.path)
    t_build = time.monotonic()
    warm_report = registry.warmup()
    service = RingService(
        engines[0], ring, max_group=serve_cfg.max_group,
        max_inflight=serve_cfg.max_inflight, threads=serve_cfg.max_workers,
        monitor_fetch_every_s=serve_cfg.monitor_fetch_every_s,
        monitor_fetch_every_requests=serve_cfg.monitor_fetch_every_requests,
        kernel_launches=lambda: quant_kernel_launches.value,
        engines=engines, replica=replica,
    )
    service.cost_ledger = ledger
    if ring.slo_armed and replica == 0:
        from mlops_tpu_torch.serve.metrics import LIFE_BREAKER_OPEN
        from mlops_tpu_torch.slo import SLOEngine
        from mlops_tpu_torch.slo.engine import SLO_NAMES, read_slo_view

        # The lead replica evaluates the fleet's SLOs from the ring's
        # counters, seeded with a dead predecessor's published totals so
        # the exported counters never go back.
        prev = read_slo_view(ring.slo_vals, ring.alert_vals, ring.tenant_names,
                             tuple(float(x) for x in ring.slo_meta[:4]))
        prior = {name: tuple(prev[name]["slos"][slo][field]
                             for slo in SLO_NAMES for field in ("good", "total"))
                 for name in ring.tenant_names}
        service.slo = SLOEngine(
            slo_cfg, ring.tenant_names,
            source=lambda: ring.slo_counts(slo_cfg.latency_threshold_ms),
            breaker_source=lambda: {name: bool(ring.life_vals[t, LIFE_BREAKER_OPEN])
                                    for t, name in enumerate(ring.tenant_names)},
            prior_counts=prior,
        )
        logger.info("SLO engine armed (lead replica)")
    profiler = None
    if serve_cfg.profile_dir and replica == 0:
        from mlops_tpu_torch.serve.server import TorchProfiler

        profiler = TorchProfiler(serve_cfg.profile_dir)
        service.profiler = profiler.control
    # Warmup -> re-attach -> serve: the busy slots routed to this replica
    # are answered by the replay before its ready flag flips.
    attach = service.reattach()
    service.start()
    logger.info("engine replica %d (pid %d) serving %d tenant(s) %s (tier=%s, tiers=%s, "
                "device=%s)", replica, os.getpid(), len(engines), list(registry.names),
                getattr(engines[0], "serve_tier", ""),
                ",".join(getattr(engines[0], "available_tiers", ())),
                getattr(engines[0], "device", ""))
    ring.set_ready(True, replica)
    ring.eng_vals[replica, ENG_DOWN_SINCE] = 0.0
    logger.info("warmup complete; ready %s", _LazyJson({
        "replica": replica, "pid": os.getpid(),
        "ready_s": round(time.monotonic() - t0, 3),
        "import_s": round(t_import - t0, 3), "build_s": round(t_build - t_import, 3),
        "nvcc_calls": cuda_build.nvcc_calls(),
        "tenants": list(registry.names),
        "tiers": list(getattr(engines[0], "available_tiers", ())),
        "device": str(getattr(engines[0], "device", "")),
        "warmup": warm_report, **attach,
    }))
    controllers: list = []
    if config.lifecycle.enabled and replica == 0:
        from mlops_tpu_torch.lifecycle.controller import LifecycleController
        from mlops_tpu_torch.tenancy.registry import tenant_scoped_config

        # One loop per tenant, each on its own state directory (the
        # one-tenant "default" fleet keeps lifecycle.dir). The front ends
        # encode with the preprocessors loaded at fork: they are part of
        # the promotion contract here.
        single_default = registry.names == ("default",)
        for name, engine in zip(registry.names, engines):
            controller = LifecycleController(
                engine, config if single_default else tenant_scoped_config(config, name),
                force_incumbent_preprocessor=True)
            controller.start()
            controllers.append(controller)
        service.attach_lifecycle(controllers)
        logger.info("lifecycle controller started (engine process %d, generation %d, "
                    "%d tenant(s))", os.getpid(), engines[0].bundle_generation,
                    len(controllers))
    autotune = None
    if config.autotune.enabled:
        from mlops_tpu_torch.autotune import AutotuneController

        # Started after warmup: it measures the warmed grid. The lead
        # replica plans and persists; its siblings adopt.
        autotune = AutotuneController(engines[0], config.autotune,
                                      adopt=replica != 0, replica=replica)
        service.attach_autotune(autotune)
        autotune.start()
        logger.info("autotune controller started (replica %d, %s mode)", replica,
                    "adopt" if replica != 0 else "plan")
    if profiler is not None:
        # CUPTI's first start, here on the main thread that runs the
        # profile requests, before any request waits on it (the collector
        # queues one that comes meanwhile).
        logger.info("profiler primed in %.3f s (replica %d)", profiler.prime(), replica)
    supervisor = os.getppid()
    try:
        # Not stopped by the ring's drain flag: during a drain the front
        # ends finish their in-flight slots first, which needs this
        # process; the supervisor stops it after they have exited.
        while not stop:
            # A 0.5 s tick, during which this thread runs the profile
            # requests the collector hands it (replica 0).
            tick = time.monotonic() + 0.5
            while not stop and (left := tick - time.monotonic()) > 0:
                service.serve_profile(left)
            # Fault point: kill = the engine's death in process (the
            # supervisor respawns it); raise = a main-loop failure, the
            # same recovery.
            faults.fire("serve.engine.exit")
            if os.getppid() != supervisor:
                logger.error("engine replica %d: supervisor gone; exiting", replica)
                break
    finally:
        ring.set_ready(False, replica)
        for controller in controllers:
            controller.stop()
        if autotune is not None:
            autotune.stop()
        service.stop()
        if ledger is not None:
            ledger.close()  # the final atomic flush
        if followers is not None:
            followers.stop(mesh)
        logger.info("engine replica %d drained; exiting", replica)


def _check_fork_safe() -> None:
    """A fork must cross no thread and no CUDA context: the supervisor
    runs neither, and this holds it to that."""
    if threading.active_count() != 1:
        raise RuntimeError(f"refusing to fork with {threading.active_count()} threads")
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("refusing to fork a process that initialized CUDA")


def _fork(target: Callable, args: tuple, name: str) -> multiprocessing.Process:
    _check_fork_safe()
    proc = multiprocessing.get_context("fork").Process(target=target, args=args, name=name)
    proc.start()
    return proc


def _respawn(config: ServeConfig, ring: RequestRing, preprocess_paths: list[str],
             worker_id: int, tenancy: TenancyConfig, trace: Any = None,
             slo: Any = None) -> multiprocessing.Process:
    """Fork the front end of one slot partition (first boot or respawn)."""
    proc = _fork(_frontend_main,
                 (worker_id, config, ring, preprocess_paths, tenancy, trace, slo),
                 f"mlops-tpu-torch-frontend-{worker_id}")
    logger.info("frontend %d started (pid %d)", worker_id, proc.pid)
    return proc


def _spawn_engine(config: Config, ring: RequestRing, tenancy: TenancyConfig,
                  make_engine: Callable, replica: int) -> multiprocessing.Process:
    proc = _fork(_engine_main, (config, ring, tenancy, make_engine, replica),
                 f"mlops-tpu-torch-engine-{replica}")
    logger.info("engine replica %d started (pid %d)", replica, proc.pid)
    return proc


class _DrainNow(Exception):
    """A replica's crash loop: leave the supervision loop for the drain."""


# --------------------------------------------------------------- parent
def serve_multi_worker(config: Config, bundle_dir: str,
                       make_engine: Callable = build_engine) -> int:
    """The supervisor: ring -> fork the front ends -> fork the engine
    replicas (replica 0 first) -> supervise (respawn what dies) -> drain
    on SIGTERM. Returns the exit code: 0 after a drain, 1 after a
    replica's crash loop. ``make_engine(config, bundle_dir)`` builds one
    tenant's engine in a replica process; with ``serve.tenants_path`` the
    fleet is that file's (``bundle_dir`` is unused), else the one
    ``default`` tenant serving ``bundle_dir``."""
    serve_cfg = config.serve.validate()
    if serve_cfg.tenants_path:
        try:
            tenancy = load_tenants_toml(serve_cfg.tenants_path).validate()
        except ValueError as err:
            raise SystemExit(str(err)) from err
    else:
        tenancy = single_tenant_config(bundle_dir)
    replicas = serve_cfg.engine_replicas
    if replicas > 1 and config.lifecycle.enabled:
        # One controller hot-swaps one engine process's bundle: a replica
        # fleet would serve mixed generations.
        raise SystemExit(
            "serve.engine_replicas > 1 is incompatible with "
            "lifecycle.enabled: the lifecycle controller hot-swaps one "
            "engine process's bundle, and a replica fleet would serve "
            "mixed generations — run E=1 with the lifecycle loop, or "
            "the replica set without it. (The autotune plane's "
            "lead-plans/siblings-adopt regrid protocol covers exec-table "
            "changes only, not bundle promotion — see docs/operations.md)"
        )
    preprocess_paths = []
    for spec in tenancy.tenants:
        path = Path(spec.bundle_dir) / "preprocess.npz"
        if not path.is_file():
            raise SystemExit(f"no preprocessor at {path} (tenant {spec.name!r})")
        preprocess_paths.append(str(path))
    # The request cap never exceeds the largest warmed bucket; the front
    # ends' 413 gate enforces the clamped cap, sized into the slabs.
    max_batch = min(serve_cfg.max_batch, max(serve_cfg.warmup_batch_sizes))
    ring = RequestRing(workers=serve_cfg.workers, slots_small=serve_cfg.ring_slots_small,
                       slots_large=serve_cfg.ring_slots_large, large_rows=max_batch,
                       tenant_names=tenancy.names, replicas=replicas)
    trace_cfg = slo_cfg = None
    if config.trace.enabled:
        # Before any fork: the children write into the directory, and the
        # engines stamp slots once the word is set.
        trace_cfg = config.trace.validate()
        Path(trace_cfg.dir).mkdir(parents=True, exist_ok=True)
        ring.set_tracing(True)
    if config.slo.enabled or config.slo.ledger_dir:
        slo_cfg = config.slo.validate()
        if slo_cfg.enabled:
            ring.arm_slo(slo_cfg)
    placeholder = reuseport_socket(serve_cfg.host, serve_cfg.port)
    child_cfg = dataclasses.replace(serve_cfg, port=placeholder.getsockname()[1],
                                    max_batch=max_batch)
    fe_args = (tenancy, trace_cfg, slo_cfg)
    procs = [_respawn(child_cfg, ring, preprocess_paths, w, *fe_args)
             for w in range(serve_cfg.workers)]
    # Replica 0 first; the others fork once it is ready, so on a cold
    # kernel cache one replica runs nvcc and the rest load its libraries.
    engines: list[multiprocessing.Process | None] = [
        _spawn_engine(config, ring, tenancy, make_engine, 0)] + [None] * (replicas - 1)
    logger.info("supervisor %d serving %s on %s:%s with %d SO_REUSEPORT front ends, "
                "%d engine replica(s), %d tenant(s) %s", os.getpid(),
                serve_cfg.service_name, child_cfg.host, child_cfg.port,
                serve_cfg.workers, replicas, len(tenancy.tenants), list(tenancy.names))
    stopping: list[int] = []  # a signal handler appends; the loop polls
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    signal.signal(signal.SIGINT, lambda *_: stopping.append(1))
    # One crash-loop window per replica: two replicas each dying twice
    # are two brownouts, not one crash loop.
    deaths: list[list[float]] = [[] for _ in range(replicas)]
    rc = 0
    try:
        while not stopping:
            time.sleep(_SUPERVISE_TICK_S)
            for i, proc in enumerate(procs):
                if not proc.is_alive() and not stopping:
                    logger.error("frontend %d (pid %d) died with exit code %s; respawning",
                                 i, proc.pid, proc.exitcode)
                    procs[i] = _respawn(child_cfg, ring, preprocess_paths, i, *fe_args)
            if engines[-1] is None and ring.rep_ready[0]:
                for r in range(1, replicas):
                    engines[r] = _spawn_engine(config, ring, tenancy, make_engine, r)
            for r, engine in enumerate(engines):
                if engine is None or engine.is_alive() or stopping:
                    continue
                now = time.monotonic()
                deaths[r] = [t for t in deaths[r] if now - t < _ENGINE_STORM_WINDOW_S] + [now]
                if len(deaths[r]) > _ENGINE_STORM_DEATHS:
                    logger.error("engine replica %d died %d times inside %.0f s: a crash "
                                 "loop; draining", r, len(deaths[r]), _ENGINE_STORM_WINDOW_S)
                    rc = 1
                    raise _DrainNow
                logger.error("engine replica %d (pid %d) died with exit code %s; "
                             "respawning", r, engine.pid, engine.exitcode)
                # This replica's brownout begins: its ready word drops (the
                # router routes around it), its death stamped in its own
                # row for the Retry-After arithmetic, the respawn counted.
                ring.set_ready(False, r)
                ring.eng_vals[r, ENG_DOWN_SINCE] = now
                ring.eng_vals[r, ENG_RESPAWNS] += 1
                engines[r] = _spawn_engine(config, ring, tenancy, make_engine, r)
    except _DrainNow:
        pass
    finally:
        # Front ends first (their in-flight slots need the engines), then
        # the replicas; one join budget each, then SIGKILL.
        ring.set_draining()
        for proc in procs:
            if proc.is_alive():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(proc.pid, signal.SIGTERM)
        _join(procs, serve_cfg.zygote_join_deadline_s, "frontend")
        live = [e for e in engines if e is not None]
        for engine in live:
            if engine.is_alive():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(engine.pid, signal.SIGTERM)
        _join(live, serve_cfg.engine_zygote_join_s, "engine replica")
        placeholder.close()
        ring.close()
        logger.info("multi-worker plane drained; exiting")
    return rc


def _join(procs: list[multiprocessing.Process], budget_s: float, what: str) -> None:
    """Join ``procs`` within one shared budget, SIGKILL the stragglers,
    and log each one's exit code (``<what> <index> (pid N) exited C``)."""
    deadline = time.monotonic() + budget_s
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    for i, proc in enumerate(procs):
        if proc.is_alive():
            logger.error("%s (pid %d) ignored SIGTERM; killing it", what, proc.pid)
            proc.kill()
            proc.join(timeout=5)
        logger.info("%s %d (pid %d) exited %s", what, i, proc.pid, proc.exitcode)
