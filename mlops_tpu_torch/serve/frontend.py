"""The multi-worker ring plane: ``SO_REUSEPORT`` front ends + one engine.

The port's copy of the JAX package's ``serve/frontend.py`` for one
tenant and one engine process. ``serve --workers N`` (``serve.workers``
>= 2, ``MLOPS_TPU_SERVE_WORKERS``) replaces the single-process server
with N front-end processes that each bind the same host:port through
``SO_REUSEPORT``: the kernel spreads accepted connections over them, so
HTTP parsing, validation, encoding and response formatting run on N
cores, all feeding one engine process over the shared-memory ring
(``serve/ipc.py``). The engine process holds everything expensive once:
the bundle, the kernels, the CUDA graphs, the monitor accumulator.

Process model: the parent is a supervisor without threads and without
torch. It builds the ring, reserves the port and forks every other
process: the N front ends and the engine child, which imports torch and
touches the card only after the fork, so no fork ever crosses a thread
or a CUDA context (each fork checks it). Respawns fork from the same
clean supervisor. A crashed front end is respawned and re-attaches to its
slot partition through the generation counters. A dead engine is a
brownout, not an outage: the supervisor forks a replacement, which loads
its kernels from ``cache.dir`` (no nvcc), captures its graphs,
re-attaches under a new incarnation and replays every busy slot
(``RingService.reattach``). Meanwhile in-flight requests park against
their deadline budgets (200 when the replay lands in time, 504 past the
budget) and new admissions park until the partition fills; then the shed
503's Retry-After advertises the respawn ETA. More than five engine deaths
in 60 s is a crash loop: the supervisor drains and exits 1.

Load shedding: each front end's slot partition is its bounded admission
queue per slot class. No free slot answers ``503`` with Retry-After at
once; with ``serve.tier_routing`` the brownout governor first demotes
default-class requests to the cheaper tier as the partition fills.

The lifecycle loop (``lifecycle.enabled=true``) runs engine-side, in
the only process with the card, the graphs and the monitor accumulator:
after warmup and re-attach the engine process starts a
``LifecycleController`` on its engine (the front ends encode with the
fork-time preprocessor, so a refit is forced off), and the ring's
telemetry thread mirrors its gauges into shared memory for every front
end's ``/metrics``. A respawned engine serves the fork-time bundle again
at generation 1, as the JAX plane does, restarts the loop from the
on-disk reservoir, and carries the dead incarnation's lifecycle counters
as bases.

Graceful drain: SIGTERM to the supervisor reaches every front end; each
stops accepting, finishes its in-flight exchanges (the engine keeps
answering meanwhile) and exits; then the supervisor stops the engine,
which stops its lifecycle loop, finishes its jobs and writes its last
monitor aggregate and lifecycle gauges.

Not ported (ROADMAP A4): the engine replica set, tenancy, tracing spans,
``/debug/profile`` over the ring (the front ends answer 404), the SLO
engine and flight recorder, the autotuner.
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
    CTL_TIERS,
    RequestRing,
    RingClient,
    RingService,
    ShmWorkerMetrics,
)
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

logger = logging.getLogger("mlops_tpu_torch.serve")

# More engine deaths than this inside the window is a crash loop, not a
# blip: the supervisor drains and exits 1 for the orchestrator to restart.
_ENGINE_STORM_DEATHS = 5
_ENGINE_STORM_WINDOW_S = 60.0
_SUPERVISE_TICK_S = 0.25


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
    ``/predict`` shell, with the engine call replaced by claim a slot ->
    encode into its slab -> await the completion doorbell -> encode the
    raw response arrays with the single-process plane's wire formatter,
    so answers are byte-identical to it."""

    def __init__(self, config: ServeConfig, ring: RequestRing, worker_id: int,
                 preprocessor: Any) -> None:
        super().__init__(config)
        self.ring = ring
        self.worker_id = worker_id
        self.preprocessor = preprocessor
        self.client = RingClient(ring, worker_id)
        self.metrics = ShmWorkerMetrics(ring, worker_id)
        # The large slabs are sized to the (bucket-clamped) request cap.
        self.max_batch = min(config.max_batch, ring.large_rows)
        # Demote before shed, per worker, fed by this worker's partition
        # occupancy: the resource whose exhaustion sheds.
        self._brownout = (
            BrownoutGovernor(demote_depth=config.brownout_demote_depth,
                             restore_depth=config.brownout_restore_depth)
            if config.tier_routing else None
        )

    @property
    def slo_routing(self) -> bool:
        """Armed as the single-process server arms it: asked for, and the
        engine holds a second tier (the engine publishes its tier count)."""
        return self._brownout is not None and self.ring.ctl[CTL_TIERS] > 1

    def _ready(self) -> bool:
        return self.ring.engine_ready and not self.draining

    def _outage(self) -> bool:
        """The supervisor stamped the engine's death and no engine is up:
        a real outage, not a first boot still warming."""
        return not self.ring.engine_ready and self.ring.eng_vals[ENG_DOWN_SINCE] > 0

    def _respawn_retry_after(self) -> int:
        """Retry-After of a brownout 503: the respawn ETA less the time
        the outage has run, the full ETA again once that is blown, never
        under 1 s."""
        eta = self.config.engine_respawn_eta_s
        remaining = eta - (time.monotonic() - float(self.ring.eng_vals[ENG_DOWN_SINCE]))
        return max(1, math.ceil(remaining if remaining > 0 else eta))

    async def _metrics_endpoint(self):
        # Every series renders from shared memory: any worker answers a
        # scrape with the whole plane, which SO_REUSEPORT requires.
        return 200, render_ring_metrics(self.ring), "text/plain; version=0.0.4"

    async def _profile(self, action: str):
        # The trace belongs to the engine process; forwarding it over the
        # ring is not ported (ROADMAP A4).
        return profile_payload(404, action, "")

    def _shed(self, n: int) -> tuple:
        """The 503 of a full partition: Retry-After as configured, or the
        respawn ETA while the engine is down (a brownout shed)."""
        self.client.count_shed(n)
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
                     deadline: float | None, slo: int):
        """Slot admission before encode (a shed costs nothing), encode
        into the slab, then the slot's round trip. The deadline budget
        rides the slot header, so the engine completes an expired
        descriptor unscored, and bounds the completion wait."""
        if not records:
            return EMPTY_RESPONSE_BYTES
        # Fault point: kill = a front end's crash mid-request (the
        # supervisor's respawn and the slot quarantine).
        faults.fire("serve.frontend.predict")
        n = len(records)
        demoted = False
        if self.slo_routing:
            self._brownout.observe(self.client.pressure())
            slo, demoted = self._brownout.route(slo)
        slot = self.client.claim(n, slo)
        if slot is None:
            return self._shed(n)
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
            ds = self.preprocessor.encode(records_to_columns(records))
            future = self.client.submit(slot, ds.cat_ids, ds.numeric, deadline=deadline)
            submitted = True
            timeout = self.config.request_timeout_s or None
            if deadline is not None:
                remaining = deadline - loop.time()
                timeout = min(timeout or remaining, remaining)
            # Parked: admitted while the engine is down; the respawned
            # engine's replay answers it, or its deadline does.
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
            # The encode reads every float, so the slab is free after it.
            response = encode_response(*self.client.response_arrays(slot))
            self.client.release(slot)
            slot = None
            return response
        # Request boundary: any failure is a logged 500, never a dropped
        # connection or a leaked slot.
        except Exception:
            logger.exception("prediction failed request_id=%s", request_id)
            if slot is not None:
                (self.client.abandon if submitted else self.client.release)(slot)
            return 500, {"detail": "prediction failed"}, "application/json"

    async def start(self) -> asyncio.AbstractServer:
        """Bind this worker's own socket and hook the completion doorbell
        into the event loop."""
        sock = reuseport_socket(self.config.host, self.config.port)
        loop = asyncio.get_running_loop()
        loop.add_reader(self.ring.worker_doorbells[self.worker_id].fileno(),
                        self.client.on_doorbell)
        # One kick: a respawned client may hold credit for completions
        # whose doorbell its dead incarnation drained.
        loop.call_soon(self.client.on_doorbell)
        return await asyncio.start_server(self.handle_connection, sock=sock)

    def stop_doorbell(self) -> None:
        with contextlib.suppress(Exception):
            asyncio.get_running_loop().remove_reader(
                self.ring.worker_doorbells[self.worker_id].fileno())


# --------------------------------------------------------------- children
def _frontend_main(worker_id: int, config: ServeConfig, ring: RequestRing,
                   preprocess_path: str) -> None:
    """A front-end process (forked; everything arrives by inheritance).
    It never imports torch and never touches the device."""
    from mlops_tpu_torch.data.encode import Preprocessor

    preprocessor = Preprocessor.load(preprocess_path)
    with contextlib.suppress(KeyboardInterrupt):
        asyncio.run(_run_frontend(worker_id, config, ring, preprocessor))


async def _run_frontend(worker_id: int, config: ServeConfig, ring: RequestRing,
                        preprocessor: Any) -> None:
    server = FrontendServer(config, ring, worker_id, preprocessor)
    srv = await server.start()
    logger.info("frontend %d serving %s on %s:%s (pid %d)", worker_id,
                config.service_name, config.host, config.port, os.getpid())
    loop = asyncio.get_running_loop()
    draining = asyncio.Event()

    def _drain() -> None:
        draining.set()
        server.begin_drain(srv)

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, _drain)
    parent = os.getppid()

    async def _watch() -> None:
        # Besides SIGTERM: the ring's drain flag, or a dead supervisor
        # (nobody could respawn this worker). Engine death is no reason to
        # drain: the supervisor respawns it and requests park meanwhile.
        while not draining.is_set():
            await asyncio.sleep(0.5)
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
    logger.info("frontend %d drained; exiting", worker_id)


def build_engine(config: Config, bundle_dir: str):
    """The engine process's engine: the bundle on ``serve.device`` (the
    card unless ``cpu``), as the single-process ``serve`` builds it."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    cfg = config.serve
    return InferenceEngine(load_bundle(bundle_dir), buckets=tuple(cfg.warmup_batch_sizes),
                           serve_tier=cfg.serve_tier, device=cfg.device,
                           tier_routing=cfg.tier_routing)


def _engine_main(config: Config, ring: RequestRing, bundle_dir: str,
                 make_engine: Callable) -> None:
    """The engine process (forked from the supervisor; torch is imported
    here, after the fork): load the kernels from ``cache.dir``, build and
    warm the engine, re-attach to the ring (replaying what a dead
    predecessor left busy), start the lifecycle loop when it is enabled,
    serve until SIGTERM or the supervisor's death. First boot and every
    respawn run this same function."""
    t0 = time.monotonic()
    stop: list[int] = []  # a signal handler appends; the main loop polls
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    from mlops_tpu_torch.ops import cuda_build
    from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches

    t_import = time.monotonic()
    cuda_build.set_cache_dir(config.cache.dir)
    serve_cfg = config.serve
    engine = make_engine(config, bundle_dir)
    t_build = time.monotonic()
    engine.warmup()
    ring.ctl[CTL_TIERS] = len(engine.available_tiers)
    service = RingService(
        engine, ring, max_group=serve_cfg.max_group,
        max_inflight=serve_cfg.max_inflight, threads=serve_cfg.max_workers,
        monitor_fetch_every_s=serve_cfg.monitor_fetch_every_s,
        monitor_fetch_every_requests=serve_cfg.monitor_fetch_every_requests,
        kernel_launches=lambda: quant_kernel_launches.value,
    )
    # Warmup -> re-attach -> serve: parked requests are answered by the
    # replay before the ready flag flips.
    attach = service.reattach()
    service.start()
    logger.info("engine %d serving (tier=%s, tiers=%s, device=%s)", os.getpid(),
                getattr(engine, "serve_tier", ""), ",".join(engine.available_tiers),
                getattr(engine, "device", ""))
    ring.set_ready(True)
    ring.eng_vals[ENG_DOWN_SINCE] = 0.0
    logger.info("warmup complete; ready %s", _LazyJson({
        "pid": os.getpid(), "ready_s": round(time.monotonic() - t0, 3),
        "import_s": round(t_import - t0, 3), "build_s": round(t_build - t_import, 3),
        "nvcc_calls": cuda_build.nvcc_calls(), "tiers": list(engine.available_tiers),
        "device": str(getattr(engine, "device", "")),
        "warmup": getattr(engine, "warmup_stats", {}), **attach,
    }))
    controller = None
    if config.lifecycle.enabled:
        from mlops_tpu_torch.lifecycle.controller import LifecycleController

        # The front ends encode with the preprocessor loaded at fork: it
        # is part of the promotion contract here.
        controller = LifecycleController(engine, config, force_incumbent_preprocessor=True)
        controller.start()
        service.attach_lifecycle(controller)
        logger.info("lifecycle controller started (engine process %d, generation %d)",
                    os.getpid(), engine.bundle_generation)
    supervisor = os.getppid()
    try:
        # Not stopped by the ring's drain flag: during a drain the front
        # ends finish their in-flight slots first, which needs this
        # process; the supervisor stops it after they have exited.
        while not stop:
            time.sleep(0.5)
            # Fault point: kill = the engine's death in process (the
            # supervisor respawns it); raise = a main-loop failure, the
            # same recovery.
            faults.fire("serve.engine.exit")
            if os.getppid() != supervisor:
                logger.error("engine: supervisor gone; exiting")
                break
    finally:
        ring.set_ready(False)
        if controller is not None:
            controller.stop()
        service.stop()
        logger.info("engine process drained; exiting")


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


def _respawn(config: ServeConfig, ring: RequestRing, preprocess_path: str,
             worker_id: int) -> multiprocessing.Process:
    """Fork the front end of one slot partition (first boot or respawn)."""
    proc = _fork(_frontend_main, (worker_id, config, ring, preprocess_path),
                 f"mlops-tpu-torch-frontend-{worker_id}")
    logger.info("frontend %d started (pid %d)", worker_id, proc.pid)
    return proc


def _spawn_engine(config: Config, ring: RequestRing, bundle_dir: str,
                  make_engine: Callable) -> multiprocessing.Process:
    proc = _fork(_engine_main, (config, ring, bundle_dir, make_engine),
                 "mlops-tpu-torch-engine")
    logger.info("engine started (pid %d)", proc.pid)
    return proc


# --------------------------------------------------------------- parent
def serve_multi_worker(config: Config, bundle_dir: str,
                       make_engine: Callable = build_engine) -> int:
    """The supervisor: ring -> fork the front ends -> fork the engine ->
    supervise (respawn what dies) -> drain on SIGTERM. Returns the exit
    code: 0 after a drain, 1 after an engine crash loop.
    ``make_engine(config, bundle_dir)`` builds the engine in the engine
    process."""
    serve_cfg = config.serve.validate()
    preprocess_path = Path(bundle_dir) / "preprocess.npz"
    if not preprocess_path.is_file():
        raise SystemExit(f"no preprocessor at {preprocess_path}")
    if serve_cfg.profile_dir:
        logger.warning("serve.profile_dir is not forwarded over the ring "
                       "(ROADMAP A4): /debug/profile answers 404")
    # The request cap never exceeds the largest warmed bucket; the front
    # ends' 413 gate enforces the clamped cap, sized into the slabs.
    max_batch = min(serve_cfg.max_batch, max(serve_cfg.warmup_batch_sizes))
    ring = RequestRing(workers=serve_cfg.workers, slots_small=serve_cfg.ring_slots_small,
                       slots_large=serve_cfg.ring_slots_large, large_rows=max_batch)
    placeholder = reuseport_socket(serve_cfg.host, serve_cfg.port)
    child_cfg = dataclasses.replace(serve_cfg, port=placeholder.getsockname()[1],
                                    max_batch=max_batch)
    procs = [_respawn(child_cfg, ring, str(preprocess_path), w)
             for w in range(serve_cfg.workers)]
    engine = _spawn_engine(config, ring, bundle_dir, make_engine)
    logger.info("supervisor %d serving %s on %s:%s with %d SO_REUSEPORT front ends",
                os.getpid(), serve_cfg.service_name, child_cfg.host, child_cfg.port,
                serve_cfg.workers)
    stopping: list[int] = []  # a signal handler appends; the loop polls
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    signal.signal(signal.SIGINT, lambda *_: stopping.append(1))
    deaths: list[float] = []
    rc = 0
    try:
        while not stopping:
            time.sleep(_SUPERVISE_TICK_S)
            for i, proc in enumerate(procs):
                if not proc.is_alive() and not stopping:
                    logger.error("frontend %d (pid %d) died with exit code %s; respawning",
                                 i, proc.pid, proc.exitcode)
                    procs[i] = _respawn(child_cfg, ring, str(preprocess_path), i)
            if engine.is_alive() or stopping:
                continue
            now = time.monotonic()
            deaths = [t for t in deaths if now - t < _ENGINE_STORM_WINDOW_S] + [now]
            if len(deaths) > _ENGINE_STORM_DEATHS:
                logger.error("engine died %d times inside %.0f s: a crash loop; "
                             "draining", len(deaths), _ENGINE_STORM_WINDOW_S)
                rc = 1
                break
            logger.error("engine (pid %d) died with exit code %s; respawning",
                         engine.pid, engine.exitcode)
            # The brownout begins: not ready, the outage stamped for the
            # Retry-After arithmetic, the respawn counted.
            ring.set_ready(False)
            ring.eng_vals[ENG_DOWN_SINCE] = now
            ring.eng_vals[ENG_RESPAWNS] += 1
            engine = _spawn_engine(config, ring, bundle_dir, make_engine)
    finally:
        # Front ends first (their in-flight slots need the engine), then
        # the engine; one join budget each, then SIGKILL.
        ring.set_draining()
        for proc in procs:
            if proc.is_alive():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(proc.pid, signal.SIGTERM)
        _join(procs, serve_cfg.zygote_join_deadline_s, "frontend")
        if engine.is_alive():
            with contextlib.suppress(ProcessLookupError):
                os.kill(engine.pid, signal.SIGTERM)
        _join([engine], serve_cfg.engine_zygote_join_s, "engine")
        placeholder.close()
        ring.close()
        logger.info("multi-worker plane drained; exiting")
    return rc


def _join(procs: list[multiprocessing.Process], budget_s: float, what: str) -> None:
    """Join ``procs`` within one shared budget, SIGKILL the stragglers,
    and log each one's exit code."""
    deadline = time.monotonic() + budget_s
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    for i, proc in enumerate(procs):
        if proc.is_alive():
            logger.error("%s (pid %d) ignored SIGTERM; killing it", what, proc.pid)
            proc.kill()
            proc.join(timeout=5)
        label = f"{what} {i}" if what == "frontend" else what
        logger.info("%s (pid %d) exited %s", label, proc.pid, proc.exitcode)
