"""A small asyncio HTTP/1.1 server for the engine (exact or quant tier,
or both with SLO tier routing): the single-process plane.

The JAX package's single-process plane (``serve/server.py`` over
``serve/httpcore.py``); with ``trace=`` (enabled) every ``/predict``
records a span to ``<trace.dir>/spans.jsonl`` (the batcher stamps
``queue``, the engine ``encode`` / ``dispatch`` / ``device_fetch``) and
the engines feed one ``ShapeStats``; with ``slo=`` (enabled) an
``SLOEngine`` ticks every ``slo.tick_s`` over this server's counters, a
``FlightRecorder`` dumps on an alert, a 5xx spike, a fatal error or a
SIGTERM with evidence, and ``/healthz`` answers the verdict; with
``slo.ledger_dir`` a ``CostLedger`` bills every dispatch. With
``lifecycle=`` it runs the closed lifecycle loop's controller
(``lifecycle/controller.py``): started once warmup is done, its gauges on
``/metrics``, drained on SIGTERM. With ``autotune=`` (an
``AutotuneController``, ``autotune/``) the traffic-shape autotuner runs
beside it: started after warmup, its gauges on ``/metrics``
(``mlops_tpu_grid_generation``, plans by outcome), stopped on drain.
With ``registry=`` (a
``tenancy.TenantRegistry``) it serves a tenant fleet: one engine and one
micro-batcher per tenant over the one executor, the dispatch and fetch
bounds divided by the tenant count (each tenant's slice of the pool is
its own, so a hot tenant's flood queues in its own batcher: this plane
has no quota governor), requests routed by ``x-tenant``, the monitor
read per tenant (one tenant's failed read never freezes the others'),
one lifecycle controller per tenant, and the ``tenant`` label on every
per-tenant series. The HTTP protocol, the docs and health routes and the
``POST /predict`` shell are ``serve/httpcore.py``'s, shared with the
multi-worker front ends (``serve/frontend.py``); this module scores in
process:

- ``POST /predict`` — validate (422), cap the batch (413), log the
  reference's two structured events (``InferenceData`` before scoring,
  ``ModelOutput`` after; ``serve.log_sample_rate`` samples the pair),
  then score through the micro-batcher (``serve/batcher.py``): concurrent
  small requests coalesce into one grouped dispatch, up to
  ``max_inflight`` dispatches overlap. The request deadline
  (``x-request-deadline-ms``; ``serve.request_timeout_s`` for a stalled
  device) answers 504; any scoring failure 500. With
  ``serve.tier_routing`` each request's SLO class (``x-slo-class``, or a
  tight deadline) picks its tier, and the brownout governor demotes
  default-class traffic to the cheaper tier under load;
- ``GET /``, ``/docs/plain``, ``/openapi.json`` — the API's docs;
- ``GET /healthz`` (the verdict), ``/healthz/live``, ``/healthz/ready``
  (503 until warmup is done, and again once draining);
- ``GET /metrics`` — request counters, the monitor aggregate (read from
  the device after every ``monitor_fetch_every_requests`` requests, every
  ``monitor_fetch_every_s`` seconds while traffic flows, and fresh on
  each scrape), the deadline, tier and demotion counters, the lifecycle
  block (``serve/metrics.py lifecycle_lines``) when a loop runs,
  dispatches per program and the kernel launch count;
- ``POST /debug/profile/{start,stop}`` — a ``torch.profiler`` trace of
  live traffic into ``serve.profile_dir`` (404 when it is unset); the
  ring plane's front ends forward it to engine replica 0.

The socket binds first and warmup runs behind it, so probes answer while
the engine warms. SIGTERM drains: no new connections, idle ones closed,
busy exchanges finish their response.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import os
import signal
import threading
import time
from pathlib import Path
from typing import Any

from mlops_tpu_torch.config import ServeConfig
from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
from mlops_tpu_torch.serve.batcher import MicroBatcher
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.httpcore import HttpProtocol, _LazyJson
from mlops_tpu_torch.serve.metrics import (
    KNOWN_ROUTES,
    LATENCY_BUCKETS,
    SLO_BAD_STATUSES,
    autotune_lines,
    latency_good_buckets,
    lifecycle_lines,
    loop_lag_lines,
    robustness_lines,
    survivability_lines,
)
from mlops_tpu_torch.serve.tierroute import TIERS, BrownoutGovernor
from mlops_tpu_torch.serve.wire import (
    DeadlineExceeded,
    deadline_response,
    profile_payload,
)
from mlops_tpu_torch.tenancy.router import TenantRouter

logger = logging.getLogger("mlops_tpu_torch.serve")

# tpulint Layer-3 manifest: TorchProfiler's one leaf lock serializes
# control() calls (debug-endpoint cadence, never a request path); the
# Metrics lock is a leaf around host counters.
TPULINT_LOCK_ORDER = {"TorchProfiler": ("_lock",), "Metrics": ("_lock",)}

# tpulint Layer-5 manifest: HttpServer's mutable state is EVENT-LOOP
# CONFINED: every method runs on the one asyncio thread, so none may make
# a blocking call; device and file work goes through an executor.
TPULINT_LOOP_CONFINED = ("HttpServer",)


class TorchProfiler:
    """``torch.profiler`` start/stop for the ``/debug/profile`` routes,
    with the JAX package's ``JaxProfiler`` state machine: 404 without a
    ``profile_dir``, 409 for a start while tracing or a stop while not,
    500 (logged) when the profiler fails. ``stop`` writes the trace into
    the directory (TensorBoard's format). The lock serializes calls; it
    blocks only the next profile call, never a request. Start and stop
    run on one thread, the one CUPTI's tracer was started from (the
    single-process server keeps a thread for them; the ring's replica 0
    runs them on its main thread, where its CUDA context was made)."""

    def __init__(self, profile_dir: str) -> None:
        self.profile_dir = profile_dir
        self._prof = None
        self._lock = threading.Lock()

    def prime(self) -> float:
        """Start and stop one throwaway profile on the calling thread, no
        trace written; returns its seconds. A process's first start
        initializes CUPTI, which takes seconds on the card (the ring's
        replica 0 logs them; ``chip_smoke.py`` phase 35 reports them): inside
        a ``/debug/profile/start`` it can outlast the ring front end's 10 s
        wait for the engine's answer, which then reads 500 while the trace
        runs. Without a card or a ``profile_dir`` there is nothing to
        initialize."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not self.profile_dir or not torch.cuda.is_available():
            return 0.0
        t0 = time.perf_counter()
        with self._lock:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            prof.stop()
        return time.perf_counter() - t0

    def control(self, action: str) -> tuple[int, str | None]:
        if action not in ("start", "stop") or not self.profile_dir:
            return 404, None
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        with self._lock:
            try:
                if action == "start":
                    if self._prof is not None:
                        return 409, None
                    os.makedirs(self.profile_dir, exist_ok=True)
                    activities = [ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        activities.append(ProfilerActivity.CUDA)
                    prof = profile(
                        activities=activities,
                        on_trace_ready=tensorboard_trace_handler(self.profile_dir),
                    )
                    prof.start()
                    self._prof = prof
                    return 200, None
                if self._prof is None:
                    return 409, None
                prof, self._prof = self._prof, None
                prof.stop()
                return 200, None
            # An unwritable directory or a profiler error: logged and
            # answered 500, never a dropped connection.
            except Exception as err:  # tpulint: disable=TPU201
                logger.exception("profiler %s failed", action)
                self._prof = None
                return 500, str(err)


class Metrics:
    """Request counters by (route, status, tenant), each tenant's last
    monitor snapshot and lifecycle gauges, and the deadline and
    tier-routing counters; rendered in Prometheus text format under the
    JAX package's series names, every per-tenant series with its
    ``tenant`` label. Two series are the port's own:
    ``mlops_tpu_kernel_launches_total`` and
    ``mlops_tpu_dispatches_total{entry=...}`` (dispatches per program; on
    the card each is one CUDA graph replay)."""

    def __init__(self, tenants: tuple[str, ...] = ("default",)) -> None:
        self._lock = threading.Lock()
        self.requests: dict[tuple[str, int, str], int] = {}
        # The latency SLO's source: /predict latencies per tenant in the
        # JAX histogram's buckets (not rendered: the SLO block is).
        self.predict_latency: dict[str, list[int]] = {}
        # Every route's latencies per tenant, the histogram both planes
        # render.
        self.latency: dict[str, list[int]] = {}
        self.latency_sum_ms: dict[str, float] = {}
        self.latency_n: dict[str, int] = {}
        self.degraded = 0
        self.trace_dropped = 0
        self.flight_dumps = 0
        # The loop sanitizer's window max, mirrored per scrape; 0.0 (and
        # still rendered) with serve.loop_lag_monitor off.
        self.loop_lag_ms = 0.0
        self.monitor: dict[str, dict[str, Any]] = {
            tenant: {"rows": 0.0, "outliers": 0.0, "batches": 0.0,
                     "drift_last": {}, "drift_mean": {}}
            for tenant in tenants
        }
        self.monitor_fetches = 0
        self.monitor_fetched_at: dict[str, float] = {}
        self.deadline_expired = 0
        self.tier_requests: dict[str, int] = dict.fromkeys(TIERS, 0)
        self.tier_demotions = 0
        self.brownout_demotions = 0
        self.lifecycle: dict[str, dict[str, Any]] = {}
        self.autotune: dict[str, Any] | None = None

    def observe_request(self, route: str, status: int, latency_ms: float = 0.0,
                        tenant: str = "default") -> None:
        if route not in KNOWN_ROUTES:
            route = "<other>"  # arbitrary paths never become label values
        with self._lock:
            key = (route, status, tenant)
            self.requests[key] = self.requests.get(key, 0) + 1
            hist = self.latency.setdefault(tenant, [0] * len(LATENCY_BUCKETS))
            hist[next(i for i, edge in enumerate(LATENCY_BUCKETS) if latency_ms <= edge)] += 1
            self.latency_sum_ms[tenant] = self.latency_sum_ms.get(tenant, 0.0) + latency_ms
            self.latency_n[tenant] = self.latency_n.get(tenant, 0) + 1
            if route == "/predict":
                counts = self.predict_latency.setdefault(
                    tenant, [0] * len(LATENCY_BUCKETS))
                for i, edge in enumerate(LATENCY_BUCKETS):
                    if latency_ms <= edge:
                        counts[i] += 1
                        break

    def slo_counts(self, latency_threshold_ms: float,
                   tenants: tuple[str, ...]) -> dict[str, tuple[int, int, int, int]]:
        """The SLO engine's counter source (the JAX
        ``ServingMetrics.slo_counts``): per tenant, the cumulative
        ``(avail_good, avail_total, lat_good, lat_total)`` of
        ``/predict``; any 5xx spends availability."""
        k = latency_good_buckets(latency_threshold_ms)
        out = {}
        with self._lock:
            for tenant in tenants:
                total = bad = 0
                for (route, status, t), count in self.requests.items():
                    if route == "/predict" and t == tenant:
                        total += count
                        if status in SLO_BAD_STATUSES or status >= 500:
                            bad += count
                counts = self.predict_latency.get(tenant)
                out[tenant] = (total - bad, total, sum(counts[:k]) if counts else 0,
                               sum(counts) if counts else 0)
        return out

    def set_observability(self, degraded: int, trace_dropped: int,
                          flight_dumps: int) -> None:
        """Mirror the engines' degraded dispatches, the span recorder's
        drops and the flight recorder's landed dumps (absolute totals)."""
        with self._lock:
            self.degraded = int(degraded)
            self.trace_dropped = int(trace_dropped)
            self.flight_dumps = int(flight_dumps)

    def set_loop_lag(self, lag_ms: float) -> None:
        """Mirror the loop sanitizer's window max (0.0 when the monitor
        is off or the loop stayed smooth since the last scrape)."""
        with self._lock:
            self.loop_lag_ms = float(lag_ms)

    def observe_prediction(self, response: dict[str, Any],
                           tenant: str = "default") -> None:
        """The host-side per-response fold of the JAX package, for engines
        without a device accumulator (the sklearn host hybrid): rows,
        outliers and the last drift."""
        with self._lock:
            block = self.monitor[tenant]
            block["rows"] += len(response["predictions"])
            block["outliers"] += int(sum(response["outliers"]))
            block["drift_last"] = dict(response["feature_drift_batch"])

    def set_monitor_aggregate(self, snapshot: dict[str, Any],
                              tenant: str = "default") -> None:
        with self._lock:
            self.monitor[tenant] = snapshot
            self.monitor_fetches += 1
            self.monitor_fetched_at[tenant] = time.monotonic()

    def count_deadline_expired(self) -> None:
        """One request answered 504 without its work dispatching."""
        with self._lock:
            self.deadline_expired += 1

    def set_lifecycle(self, snapshot: dict[str, Any], tenant: str = "default") -> None:
        """Install a tenant's lifecycle-controller snapshot for the next
        render."""
        if snapshot:
            with self._lock:
                self.lifecycle[tenant] = dict(snapshot)

    def set_autotune(self, snapshot: dict[str, Any] | None) -> None:
        """Install the autotune controller's snapshot for the next render."""
        if snapshot:
            with self._lock:
                self.autotune = dict(snapshot)

    def count_tier(self, tier: str) -> None:
        with self._lock:
            self.tier_requests[tier] += 1

    def count_demotion(self, brownout: bool = False) -> None:
        with self._lock:
            self.tier_demotions += 1
            if brownout:
                self.brownout_demotions += 1

    def render(self, dispatches: dict[str, int]) -> str:
        with self._lock:
            lines = ["# TYPE mlops_tpu_requests_total counter"]
            for (route, status, tenant), count in sorted(
                self.requests.items(), key=lambda kv: (kv[0][2],) + kv[0][:2]
            ):
                lines.append(
                    f'mlops_tpu_requests_total{{route="{route}",'
                    f'status="{status}",tenant="{tenant}"}} {count}'
                )
            lines.append("# TYPE mlops_tpu_request_latency_ms histogram")
            for tenant in sorted(self.latency):
                cumulative = 0
                for edge, count in zip(LATENCY_BUCKETS, self.latency[tenant]):
                    cumulative += count
                    label = "+Inf" if edge == float("inf") else str(edge)
                    lines.append(f'mlops_tpu_request_latency_ms_bucket{{le="{label}",'
                                 f'tenant="{tenant}"}} {cumulative}')
                lines.append(f'mlops_tpu_request_latency_ms_sum{{tenant="{tenant}"}} '
                             f"{self.latency_sum_ms[tenant]}")
                lines.append(f'mlops_tpu_request_latency_ms_count{{tenant="{tenant}"}} '
                             f"{self.latency_n[tenant]}")
            tenants = sorted(self.monitor)
            for name, field in (("mlops_tpu_rows_scored_total", "rows"),
                                ("mlops_tpu_outliers_total", "outliers"),
                                ("mlops_tpu_monitor_batches_total", "batches")):
                lines.append(f"# TYPE {name} counter")
                lines += [f'{name}{{tenant="{t}"}} {self.monitor[t][field]}'
                          for t in tenants]
            lines += [
                "# TYPE mlops_tpu_monitor_fetches_total counter",
                f"mlops_tpu_monitor_fetches_total {self.monitor_fetches}",
            ]
            if self.monitor_fetched_at:
                # The oldest tenant's gauges' age: one stuck tenant never
                # hides behind another's fresh fetch.
                age = time.monotonic() - min(self.monitor_fetched_at.values())
                lines += ["# TYPE mlops_tpu_monitor_fetch_age_seconds gauge",
                          f"mlops_tpu_monitor_fetch_age_seconds {age:.3f}"]
            for name, field in (("mlops_tpu_feature_drift_score", "drift_last"),
                                ("mlops_tpu_feature_drift_mean", "drift_mean")):
                lines.append(f"# TYPE {name} gauge")
                for t in tenants:
                    for feature, score in self.monitor[t][field].items():
                        lines.append(f'{name}{{feature="{feature}",tenant="{t}"}} {score}')
            lines += robustness_lines(self.deadline_expired, self.degraded,
                                      self.trace_dropped, self.flight_dumps)
            # One event loop on this plane: one worker="0" cell.
            lines += loop_lag_lines([("0", self.loop_lag_ms)])
            # The engine lives in this process: no respawn, replay or
            # parking, so the block is structurally zero, rendered all the
            # same (one series set on both planes).
            lines += survivability_lines(0, 0, 0, 0, 0)
            lines.append("# TYPE mlops_tpu_tier_requests_total counter")
            for tier in TIERS:
                lines.append(
                    f'mlops_tpu_tier_requests_total{{tier="{tier}"}} '
                    f"{self.tier_requests[tier]}"
                )
            lines += [
                "# TYPE mlops_tpu_tier_demotions_total counter",
                f"mlops_tpu_tier_demotions_total {self.tier_demotions}",
                "# TYPE mlops_tpu_brownout_demote_total counter",
                f"mlops_tpu_brownout_demote_total {self.brownout_demotions}",
            ]
            for tenant in sorted(self.lifecycle):
                lines += lifecycle_lines(self.lifecycle[tenant], tenant)
            lines += autotune_lines(self.autotune)
        lines.append("# TYPE mlops_tpu_dispatches_total counter")
        for entry, count in sorted(dispatches.items()):
            lines.append(f'mlops_tpu_dispatches_total{{entry="{entry}"}} {count}')
        lines += [
            "# TYPE mlops_tpu_kernel_launches_total counter",
            'mlops_tpu_kernel_launches_total{kernel="quant_fused"} '
            f"{quant_kernel_launches.value}",
        ]
        return "\n".join(lines) + "\n"


class HttpServer(HttpProtocol):
    def __init__(self, engine: InferenceEngine, config: ServeConfig,
                 lifecycle=None, registry=None):
        super().__init__(config.validate())
        # The tenant fleet: ``registry`` (a ``TenantRegistry``) puts one
        # engine per tenant behind this plane; None is the one-tenant
        # fleet around ``engine``.
        self.registry = registry
        self.engines = list(registry.engines) if registry is not None else [engine]
        self.engine = registry.default_engine if registry is not None else engine
        if registry is not None:
            self.tenants = TenantRouter(registry.names, registry.default_index)
        # The lifecycle controllers (``lifecycle/controller.py``), when the
        # loop runs, one per tenant (a bare one is the one-tenant form):
        # ``serve`` starts them after warmup and stops them on drain.
        self.lifecycle = lifecycle
        # The autotune controller, when armed (``serve`` starts it after
        # warmup and stops it on drain).
        self.autotune = None
        self.metrics = Metrics(self.tenants.names)
        # The request cap never exceeds the largest warmed bucket.
        self.max_batch = min(config.max_batch, min(e.max_bucket for e in self.engines))
        max_inflight = config.max_inflight
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=config.max_workers, thread_name_prefix="predict"
        )
        self._profiler = TorchProfiler(config.profile_dir)
        # The profiler's one thread (``TorchProfiler``'s contract).
        self._profile_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="profile"
        )
        # Armed by ``serve``: the SLO engine (ticked by its own timer task
        # and on scrapes) and the cost ledger (rendered on scrapes).
        self.slo_engine = None
        self.cost_ledger = None
        self._slo_task: asyncio.Task | None = None
        # One batcher per tenant over the one executor: validate()
        # guarantees the dispatch bound, the fetch ring (>= 1) and one
        # thread of headroom (the solo fast path, monitor fetches) fit the
        # pool, and a fleet divides the bounds (at least 1 each): each
        # tenant's slice of the pool is its own.
        fetch_inflight = min(
            max_inflight, max(1, config.max_workers - max_inflight - 1)
        )
        n_tenants = len(self.engines)
        self.batchers = [
            MicroBatcher(
                eng,
                self._executor,
                window_ms=config.batch_window_ms,
                max_group=config.max_group,
                max_inflight=max(1, max_inflight // n_tenants),
                fetch_inflight=max(1, fetch_inflight // n_tenants),
                batch_mode=config.batch_mode,
                admit_fraction=config.batch_admit_fraction,
                # Accumulating engines fold their monitor totals on the
                # device, so they take the wire path (responses encoded in
                # the executor). The host hybrid (rf) keeps dicts: the
                # server folds its totals from each response.
                wire_responses=eng.monitor_accumulating,
            )
            for eng in self.engines
        ]
        self._accumulating = [eng.monitor_accumulating for eng in self.engines]
        self.batcher = self.batchers[self.tenants.default_index]
        # SLO tier routing and brownout: armed only when asked for and an
        # engine holds a second tier. Pressure is the in-flight predict
        # depth over the dispatch capacity (max_inflight groups of
        # max_group requests).
        self.slo_routing = config.tier_routing and any(
            len(eng.available_tiers) > 1 for eng in self.engines)
        self._brownout = (
            BrownoutGovernor(
                demote_depth=config.brownout_demote_depth,
                restore_depth=config.brownout_restore_depth,
            )
            if self.slo_routing
            else None
        )
        self._score_inflight = 0
        self._score_capacity = max(1, max_inflight * self.batcher.max_group)
        # Monitor telemetry: the request path only counts requests; the
        # aggregate is read off the hot path (after K requests, on the
        # timer, on scrapes) through one single-flight task.
        self._monitor_requests = 0
        self._monitor_task: asyncio.Task | None = None
        self._monitor_timer_task: asyncio.Task | None = None

    async def start(self) -> asyncio.AbstractServer:
        if any(self._accumulating) and self.config.monitor_fetch_every_s > 0:
            self._monitor_timer_task = asyncio.get_running_loop().create_task(
                self._monitor_timer()
            )
        if self.slo_engine is not None:
            self._slo_task = asyncio.get_running_loop().create_task(self._slo_timer())
        return await asyncio.start_server(
            self.handle_connection, self.config.host, self.config.port
        )

    async def _slo_timer(self) -> None:
        """The SLO engine's cadence: burn rates and alert edges (the flight
        recorder's trigger) advance when nobody scrapes too."""
        while True:
            await asyncio.sleep(self.slo_engine.config.tick_s)
            try:
                self.slo_engine.tick()
            # An evaluator failure costs one tick of freshness, logged; the
            # next tick retries.
            except Exception:  # tpulint: disable=TPU201
                logger.exception("slo tick failed; alert gauges stale")

    def _slo_view(self):
        return None if self.slo_engine is None else self.slo_engine.view()

    def stop_telemetry(self) -> None:
        """Cancel the monitor and SLO timers and any fetch in flight."""
        for task in (self._monitor_timer_task, self._monitor_task, self._slo_task):
            if task is not None and not task.done():
                task.cancel()

    def close(self) -> None:
        self._executor.shutdown(wait=True)
        self._profile_thread.shutdown(wait=True)

    # ------------------------------------------------------------- scoring
    async def _score(self, records: list[dict], request_id: str,
                     deadline: float | None, slo: int, tenant: int = 0, span=None):
        """The tenant's micro-batcher -> its engine, with the deadline and
        failure contracts (tenants share the pool, never a dispatch).
        ``slo`` maps to a tier of that engine, through the brownout
        governor first. ``span`` rides into the batcher and the engine
        for their stamps; one an engine call may still stamp after this
        request gave up on it is marked abandoned and never recorded."""
        engine = self.engines[tenant]
        tier: str | None = None
        if self._brownout is not None:
            self._brownout.observe(self._score_inflight / self._score_capacity)
            routed, demoted = self._brownout.route(slo)
            tier = engine.route_tier(routed)
            self.metrics.count_tier(tier or engine.default_tier)
            if demoted:
                self.metrics.count_demotion(brownout=True)
            if span is not None:
                span.tier = tier or engine.default_tier
        self._score_inflight += 1
        try:
            # The timeout exists for a stalled device; a client's deadline
            # budget tightens it per request and rides into the batcher, so
            # an expired entry is purged instead of dispatched.
            timeout = self.config.request_timeout_s or None
            if deadline is not None:
                remaining = deadline - asyncio.get_running_loop().time()
                timeout = min(timeout or remaining, remaining)
            # The span rides only when tracing is armed: the disarmed call
            # keeps the batcher's call shape.
            traced = {} if span is None else {"span": span}
            call = self.batchers[tenant].predict(records, deadline=deadline, tier=tier,
                                                 **traced)
            if timeout is not None:
                response = await asyncio.wait_for(call, max(timeout, 0.0))
            else:
                response = await call
        except DeadlineExceeded:
            self.metrics.count_deadline_expired()
            return deadline_response()
        except asyncio.TimeoutError:
            logger.error(
                "prediction deadline (%.1fs) exceeded request_id=%s — "
                "device stall?", timeout, request_id,
            )
            if span is not None:
                span.abandoned = True  # the engine call may still stamp it
            return deadline_response(
                f"prediction exceeded the {timeout:g}s deadline"
            )
        # Request boundary: any scoring failure (device error included)
        # becomes a logged 500, never a dropped connection.
        except Exception:  # tpulint: disable=TPU201
            logger.exception("prediction failed request_id=%s", request_id)
            if span is not None:
                span.abandoned = True  # a grouped dispatch may outlive us
            return 500, {"detail": "prediction failed"}, "application/json"
        finally:
            self._score_inflight -= 1
        if self._accumulating[tenant]:
            # Folded on the device: the request path only counts toward
            # the K-request fetch trigger.
            self._monitor_requests += 1
            self._maybe_fetch_monitor()
        else:
            self.metrics.observe_prediction(response, tenant=self.tenants.names[tenant])
        return response

    # ------------------------------------------------- monitor telemetry
    def _spawn_monitor_fetch(self) -> asyncio.Task:
        """Single-flight aggregate fetch: every trigger (K requests, the
        timer, a scrape) funnels through one task, so an older snapshot
        can never be applied after a newer one."""
        task = self._monitor_task
        if task is None or task.done():
            task = asyncio.get_running_loop().create_task(self._fetch_monitor())
            task.add_done_callback(self._observe_monitor_fetch)
            self._monitor_task = task
        return task

    @staticmethod
    def _observe_monitor_fetch(task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.error(
                "monitor aggregate fetch failed; gauges keep their last "
                "values until the next trigger succeeds",
                exc_info=task.exception(),
            )

    def _maybe_fetch_monitor(self) -> None:
        k = self.config.monitor_fetch_every_requests
        if k and self._monitor_requests >= k:
            self._spawn_monitor_fetch()

    async def _fetch_monitor(self) -> None:
        """One aggregate read per tenant, in turn on the executor. A
        tenant's failed read keeps its gauges and never stops the
        others'; a one-tenant plane's failure reaches the done-callback
        log."""
        loop = asyncio.get_running_loop()
        self._monitor_requests = 0
        failed = None
        for name, engine, accumulating in zip(self.tenants.names, self.engines,
                                              self._accumulating):
            if not accumulating:
                continue  # the host hybrid's totals are folded per response
            try:
                snapshot = await loop.run_in_executor(self._executor,
                                                      engine.monitor_snapshot)
                self.metrics.set_monitor_aggregate(snapshot, tenant=name)
            except Exception as err:  # tpulint: disable=TPU201
                logger.error("monitor fetch failed for tenant %r", name, exc_info=True)
                failed = err
        if failed is not None and len(self.engines) == 1:
            raise failed

    async def _monitor_timer(self) -> None:
        """The staleness floor: a trickle of traffic that never reaches
        the K-request trigger is still read every period."""
        period = self.config.monitor_fetch_every_s
        while True:
            await asyncio.sleep(period)
            if self._monitor_requests > 0:
                self._spawn_monitor_fetch()

    async def _metrics_endpoint(self):
        # Scrapes read fresh, unless no predict arrived since the last
        # read; bounded, so a stalled device never wedges a scrape (the
        # gauges then keep their last values).
        if self._monitor_requests > 0 or self.metrics.monitor_fetches == 0:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(
                    asyncio.shield(self._spawn_monitor_fetch()), timeout=1.0
                )
        for name, controller in self._tenant_lifecycles():
            # A host dict read under the controller's leaf lock.
            self.metrics.set_lifecycle(controller.metrics_snapshot(), tenant=name)
        if self.autotune is not None:
            self.metrics.set_autotune(self.autotune.metrics_snapshot())
        dispatches: dict[str, int] = {}
        for engine in self.engines:
            for entry, count in engine.dispatch_counts().items():
                dispatches[entry] = dispatches.get(entry, 0) + count
        self.metrics.set_observability(
            sum(engine.degraded_dispatch_total for engine in self.engines),
            self.tracer.dropped if self.tracer is not None else 0,
            self.flightrec.landed if self.flightrec is not None else 0,
        )
        if self.loop_monitor is not None:
            # The worst callback since the previous scrape (the window
            # resets on read).
            self.metrics.set_loop_lag(self.loop_monitor.snapshot_ms())
        lines = [self.metrics.render(dispatches)]
        stats = self.engine.shape_stats
        if stats is not None:
            lines += stats.render_lines()
        if self.slo_engine is not None:
            # A fresh tick per scrape (cheap host arithmetic); engine_down
            # cannot hold here: the engine is this process.
            self.slo_engine.tick()
            lines += self.slo_engine.render_lines()
        if self.cost_ledger is not None:
            lines += self.cost_ledger.render_lines()
        text = lines[0] + "".join(line + "\n" for line in lines[1:])
        return 200, text, "text/plain; version=0.0.4"

    def _tenant_lifecycles(self) -> list[tuple[str, Any]]:
        """(tenant name, controller) pairs: the per-tenant list, or the
        one controller on the default tenant."""
        if self.lifecycle is None:
            return []
        if isinstance(self.lifecycle, (list, tuple)):
            return [(self.tenants.names[t], c) for t, c in enumerate(self.lifecycle)
                    if c is not None]
        return [(self.tenants.names[self.tenants.default_index], self.lifecycle)]

    async def _profile(self, action: str):
        if action not in ("start", "stop"):
            return 404, {"detail": "not found"}, "application/json"
        status, err = await asyncio.get_running_loop().run_in_executor(
            self._profile_thread, self._profiler.control, action
        )
        return profile_payload(status, action, self.config.profile_dir, err)

    # -------------------------------------------------------------- routes
    def _ready(self) -> bool:
        return all(bool(eng.ready) for eng in self.engines) and not self.draining


def arm_observability(server: HttpServer, trace=None, slo=None):
    """Install what the ``trace`` and ``slo`` sections arm on ``server``
    and its engines (the JAX ``_serve``'s wiring); returns the tracer and
    the ledger, for the drain to close. Disarmed sections leave every hook
    at None."""
    tracer = ledger = None
    if slo is not None and (slo.enabled or slo.ledger_dir):
        slo.validate()
        if slo.enabled:
            from mlops_tpu_torch.slo import FlightRecorder, SLOEngine

            tenant_names = tuple(server.tenants.names)
            if slo.flightrec_enabled:
                server.flightrec = FlightRecorder(
                    slo.flightrec_dir, capacity=slo.flightrec_capacity,
                    cooldown_s=slo.flightrec_cooldown_s, keep=slo.flightrec_keep,
                    source="single", spike_errors=slo.flightrec_spike_errors,
                    spike_window_s=slo.flightrec_spike_window_s,
                )

            def _breakers() -> dict:
                # The lifecycle breaker pages through the same channel as
                # a burn; a failed probe is logged and reads as closed.
                out = {}
                for name, controller in server._tenant_lifecycles():
                    try:
                        out[name] = bool(controller.metrics_snapshot().get("breaker_open"))
                    except Exception:  # tpulint: disable=TPU201
                        logger.exception("breaker probe failed (tenant %r)", name)
                return out

            server.slo_engine = SLOEngine(
                slo, tenant_names,
                source=lambda: server.metrics.slo_counts(slo.latency_threshold_ms,
                                                         tenant_names),
                breaker_source=_breakers,
                on_alert=server.flightrec.note_alert if server.flightrec else None,
            )
            logger.info("SLO engine armed (availability %.4f, latency %.4f @ %gms)",
                        slo.availability_target, slo.latency_target,
                        slo.latency_threshold_ms)
        if slo.ledger_dir:
            from mlops_tpu_torch.slo import CostLedger

            ledger = CostLedger(slo.ledger_dir, flush_interval_s=slo.ledger_flush_s)
            server.cost_ledger = ledger
            for eng in server.engines:
                eng.set_cost_ledger(ledger)
            logger.info("cost ledger armed -> %s", ledger.path)
    if trace is not None and trace.enabled:
        from mlops_tpu_torch.trace import ShapeStats, TraceRecorder

        trace.validate()
        tracer = TraceRecorder(Path(trace.dir) / "spans.jsonl",
                               capacity=trace.ring_capacity,
                               flush_interval_s=trace.flush_interval_s)
        server.tracer = tracer
        # One ShapeStats for the fleet: entries key by compiled shape.
        stats = ShapeStats()
        for eng in server.engines:
            eng.set_shape_stats(stats)
        logger.info("tracing armed; spans -> %s", tracer.path)
    return tracer, ledger


async def serve(engine: InferenceEngine, config: ServeConfig,
                lifecycle=None, registry=None, trace=None, slo=None,
                autotune=None) -> None:
    """Bind, warm up behind the socket, serve until SIGTERM, then drain.
    ``registry`` (a ``TenantRegistry``) serves its fleet, warmed tenant by
    tenant. ``lifecycle`` (a ``LifecycleController``, or one per tenant)
    starts once warmup is done and stops (its thread joined, the engine
    tee cleared, the reservoir saved) while the server drains. ``trace``
    and ``slo`` are the config sections (``arm_observability``).
    ``autotune`` (an ``AutotuneController``) starts after warmup too, and
    stops on drain."""
    server = HttpServer(engine, config, lifecycle=lifecycle, registry=registry)
    server.autotune = autotune
    engine = server.engine
    controllers = [c for _, c in server._tenant_lifecycles()]
    tracer, ledger = arm_observability(server, trace, slo)
    flightrec = server.flightrec
    srv = await server.start()
    logger.info(
        "serving %s on %s:%s (tier=%s, tiers=%s, device=%s)",
        config.service_name, config.host, config.port, engine.serve_tier,
        ",".join(engine.available_tiers), engine.device,
    )
    loop = asyncio.get_running_loop()
    if config.loop_lag_monitor:
        # The runtime half of the Layer-5 discipline: time every callback
        # on this loop, drained into the lag gauge on each scrape.
        from mlops_tpu_torch.analysis.loopcheck import LoopLagSanitizer

        server.loop_monitor = LoopLagSanitizer(slow_ms=config.loop_lag_slow_ms)
        server.loop_monitor.attach(loop)
        logger.info("loop-lag sanitizer armed (slow_ms=%g)", config.loop_lag_slow_ms)
    warmup_error: list[BaseException] = []

    async def _warm() -> None:
        try:
            if registry is not None:
                report = await loop.run_in_executor(None, registry.warmup)
            else:
                await loop.run_in_executor(None, engine.warmup)
                report = engine.warmup_stats
            logger.info("warmup complete; ready %s", _LazyJson(report))
            # Only once the live graphs are all captured: a trigger before
            # then would have nothing warm to shadow against.
            for controller in controllers:
                controller.start()
            if controllers:
                logger.info("lifecycle controller started (%d tenant(s))",
                            len(controllers))
            if autotune is not None:
                # It measures, and regrids, the warmed grid.
                autotune.start()
                logger.info("autotune controller started")
        # A failed warmup (kernel build, launch, graph capture, OOM) stops
        # the server: the error is re-raised below, never left as a
        # forever-503.
        except Exception as err:  # tpulint: disable=TPU201
            warmup_error.append(err)
            logger.exception("warmup failed, shutting down")
            srv.close()

    def _drain() -> None:
        logger.info("SIGTERM: draining (no new connections)")
        server.begin_drain(srv)
        if flightrec is not None:
            # A clean drain writes nothing; one during an incident keeps
            # the evidence. Off the loop: busy exchanges are finishing.
            loop.run_in_executor(None, flightrec.dump_if_evidence, "sigterm")

    try:
        loop.add_signal_handler(signal.SIGTERM, _drain)
    except (NotImplementedError, RuntimeError, ValueError):
        pass  # not the main thread, or no signal support: no drain hook
    warm_task = loop.create_task(_warm())
    try:
        await srv.serve_forever()
    except asyncio.CancelledError:
        pass
    except BaseException:
        if flightrec is not None:
            flightrec.dump("fatal")  # the post-mortem, unconditionally
        raise
    finally:
        srv.close()
        if server.loop_monitor is not None:
            server.loop_monitor.detach()
            server.loop_monitor = None
        server.stop_telemetry()
        for controller in controllers:
            # stop() joins the controller thread: never on the event loop.
            await loop.run_in_executor(None, controller.stop)
        if autotune is not None:
            await loop.run_in_executor(None, autotune.stop)
        await warm_task
        deadline = loop.time() + config.drain_deadline_s
        while server._busy and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for w in list(server._connections):
            w.close()
        await loop.run_in_executor(None, server.close)
        # After the exchanges finished: every span is recorded; both
        # closes join a writer thread, so off the loop.
        if tracer is not None:
            await loop.run_in_executor(None, tracer.close)
        if ledger is not None:
            await loop.run_in_executor(None, ledger.close)
        logger.info("drained; exiting")
    if warmup_error:
        raise SystemExit(f"warmup failed: {warmup_error[0]}")


def serve_forever(engine: InferenceEngine, config: ServeConfig,
                  lifecycle=None, registry=None, trace=None, slo=None,
                  autotune=None) -> None:
    """Blocking entry point."""
    asyncio.run(serve(engine, config, lifecycle=lifecycle, registry=registry,
                      trace=trace, slo=slo, autotune=autotune))
