"""A small asyncio HTTP/1.1 server for the engine (exact or quant tier,
or both with SLO tier routing).

The JAX package's single-process plane (``serve/httpcore.py`` +
``serve/server.py``), without tenancy, tracing spans, the SLO engine,
lifecycle or the ring plane (ROADMAP A4):

- ``POST /predict`` — validate (422), cap the batch (413), log the
  reference's two structured events (``InferenceData`` before scoring,
  ``ModelOutput`` after), then score through the micro-batcher
  (``serve/batcher.py``): concurrent small requests coalesce into one
  grouped dispatch, up to ``max_inflight`` dispatches overlap. The
  request deadline (``x-request-deadline-ms``; ``serve.request_timeout_s``
  for a stalled device) answers 504; any scoring failure 500. With
  ``serve.tier_routing`` each request's SLO class (``x-slo-class``, or a
  tight deadline) picks its tier, and the brownout governor demotes
  default-class traffic to the cheaper tier under load;
- ``GET /``, ``/docs/plain``, ``/openapi.json`` — the API's docs;
- ``GET /healthz`` (the verdict), ``/healthz/live``, ``/healthz/ready``
  (503 until warmup is done, and again once draining);
- ``GET /metrics`` — request counters, the monitor aggregate (read from
  the device after every ``monitor_fetch_every_requests`` requests, every
  ``monitor_fetch_every_s`` seconds while traffic flows, and fresh on
  each scrape), the deadline, tier and demotion counters, dispatches per
  program and the kernel launch count;
- ``POST /debug/profile/{start,stop}`` — a ``torch.profiler`` trace of
  live traffic into ``serve.profile_dir`` (404 when it is unset).

The socket binds first and warmup runs behind it, so probes answer while
the engine warms. SIGTERM drains: no new connections, idle ones closed,
busy exchanges finish their response.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import json
import logging
import os
import re
import signal
import threading
import uuid
from typing import Any

from mlops_tpu_torch.config import ServeConfig
from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
from mlops_tpu_torch.schema.validate import validate_records
from mlops_tpu_torch.serve.batcher import MicroBatcher
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.openapi import SWAGGER_HTML, build_openapi
from mlops_tpu_torch.serve.tierroute import (
    SLO_DEFAULT,
    TIERS,
    BrownoutGovernor,
    resolve_slo_class,
)
from mlops_tpu_torch.serve.wire import (
    DeadlineExceeded,
    deadline_response,
    profile_payload,
)

logger = logging.getLogger("mlops_tpu_torch.serve")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            409: "Conflict", 413: "Payload Too Large",
            422: "Unprocessable Entity", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")
MAX_BODY_BYTES = 16 * 1024 * 1024

_DOCS_HTML = """<!doctype html>
<html><head><title>{title}</title></head>
<body style="font-family: sans-serif; max-width: 42rem; margin: 2rem auto">
<h1>{title}</h1>
<p>Credit-default inference service on a CUDA card.</p>
<ul>
<li><code>POST /predict</code> — body: JSON list of loan-applicant records;
returns <code>{{"predictions": [...], "outliers": [...],
"feature_drift_batch": {{...}}}}</code></li>
<li><code>GET /healthz/live</code> — liveness probe</li>
<li><code>GET /healthz/ready</code> — readiness probe (bundle loaded + programs warm)</li>
<li><code>GET /metrics</code> — Prometheus metrics</li>
<li><code>POST /debug/profile/start</code>, <code>POST /debug/profile/stop</code>
— capture a <code>torch.profiler</code> trace (view in TensorBoard)</li>
</ul>
</body></html>"""


def _json_default(obj):
    # A ModelOutput event embeds the response's pre-encoded wire bytes;
    # parsing them back keeps the logged JSON identical to the dict form.
    if isinstance(obj, (bytes, bytearray)):
        return json.loads(obj)
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


class _LazyJson:
    """Defer the dumps of a log payload until a handler emits it."""

    __slots__ = ("_payload",)

    def __init__(self, payload):
        self._payload = payload

    def __str__(self) -> str:
        return json.dumps(
            self._payload, separators=(",", ":"), default=_json_default
        )


def health_verdict(ready: bool) -> tuple[int, dict[str, Any], str]:
    """The ``/healthz`` answer of the JAX package's single-process server
    with its SLO engine disarmed (``slo/engine.py::health_verdict`` with
    no view): "ok" once ready, else "down" with a 503."""
    verdict, status = ("ok", 200) if ready else ("down", 503)
    return (
        status,
        {"verdict": verdict, "ready": bool(ready), "alerts": []},
        "application/json",
    )


class TorchProfiler:
    """``torch.profiler`` start/stop for the ``/debug/profile`` routes,
    with the JAX package's ``JaxProfiler`` state machine: 404 without a
    ``profile_dir``, 409 for a start while tracing or a stop while not,
    500 (logged) when the profiler fails. ``stop`` writes the trace into
    the directory (TensorBoard's format). The lock serializes calls; it
    blocks only the next profile call, never a request."""

    def __init__(self, profile_dir: str) -> None:
        self.profile_dir = profile_dir
        self._prof = None
        self._lock = threading.Lock()

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
            except Exception as err:
                logger.exception("profiler %s failed", action)
                self._prof = None
                return 500, str(err)


class Metrics:
    """Request counters by (route, status), the last monitor snapshot and
    the deadline and tier-routing counters; rendered in Prometheus text
    format under the JAX package's series names. Two series are the
    port's own: ``mlops_tpu_kernel_launches_total`` and
    ``mlops_tpu_dispatches_total{entry=...}`` (dispatches per program; on
    the card each is one CUDA graph replay)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests: dict[tuple[str, int], int] = {}
        self.monitor: dict[str, Any] = {
            "rows": 0.0, "outliers": 0.0, "batches": 0.0,
            "drift_last": {}, "drift_mean": {},
        }
        self.monitor_fetches = 0
        self.deadline_expired = 0
        self.tier_requests: dict[str, int] = dict.fromkeys(TIERS, 0)
        self.tier_demotions = 0
        self.brownout_demotions = 0

    def observe_request(self, route: str, status: int) -> None:
        with self._lock:
            key = (route, status)
            self.requests[key] = self.requests.get(key, 0) + 1

    def set_monitor_aggregate(self, snapshot: dict[str, Any]) -> None:
        with self._lock:
            self.monitor = snapshot
            self.monitor_fetches += 1

    def count_deadline_expired(self) -> None:
        """One request answered 504 without its work dispatching."""
        with self._lock:
            self.deadline_expired += 1

    def count_tier(self, tier: str) -> None:
        with self._lock:
            self.tier_requests[tier] += 1

    def count_demotion(self, brownout: bool = False) -> None:
        with self._lock:
            self.tier_demotions += 1
            if brownout:
                self.brownout_demotions += 1

    def render(self, dispatches: dict[str, int]) -> str:
        t = 'tenant="default"'
        with self._lock:
            lines = ["# TYPE mlops_tpu_requests_total counter"]
            for (route, status), count in sorted(self.requests.items()):
                lines.append(
                    f'mlops_tpu_requests_total{{route="{route}",'
                    f'status="{status}",{t}}} {count}'
                )
            monitor = self.monitor
            lines += [
                "# TYPE mlops_tpu_rows_scored_total counter",
                f"mlops_tpu_rows_scored_total{{{t}}} {monitor['rows']}",
                "# TYPE mlops_tpu_outliers_total counter",
                f"mlops_tpu_outliers_total{{{t}}} {monitor['outliers']}",
                "# TYPE mlops_tpu_monitor_batches_total counter",
                f"mlops_tpu_monitor_batches_total{{{t}}} {monitor['batches']}",
                "# TYPE mlops_tpu_monitor_fetches_total counter",
                f"mlops_tpu_monitor_fetches_total {self.monitor_fetches}",
                "# TYPE mlops_tpu_feature_drift_score gauge",
            ]
            for feature, score in monitor["drift_last"].items():
                lines.append(
                    f'mlops_tpu_feature_drift_score{{feature="{feature}",{t}}} '
                    f"{score}"
                )
            lines.append("# TYPE mlops_tpu_feature_drift_mean gauge")
            for feature, score in monitor["drift_mean"].items():
                lines.append(
                    f'mlops_tpu_feature_drift_mean{{feature="{feature}",{t}}} '
                    f"{score}"
                )
            lines += [
                "# TYPE mlops_tpu_deadline_expired_total counter",
                f"mlops_tpu_deadline_expired_total {self.deadline_expired}",
                "# TYPE mlops_tpu_tier_requests_total counter",
            ]
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
        lines.append("# TYPE mlops_tpu_dispatches_total counter")
        for entry, count in sorted(dispatches.items()):
            lines.append(f'mlops_tpu_dispatches_total{{entry="{entry}"}} {count}')
        lines += [
            "# TYPE mlops_tpu_kernel_launches_total counter",
            'mlops_tpu_kernel_launches_total{kernel="quant_fused"} '
            f"{quant_kernel_launches.value}",
        ]
        return "\n".join(lines) + "\n"


class HttpServer:
    def __init__(self, engine: InferenceEngine, config: ServeConfig):
        self.engine = engine
        self.config = config.validate()
        self.metrics = Metrics()
        # The request cap never exceeds the largest warmed bucket.
        self.max_batch = min(config.max_batch, engine.max_bucket)
        max_inflight = config.max_inflight
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=config.max_workers, thread_name_prefix="predict"
        )
        self._profiler = TorchProfiler(config.profile_dir)
        # One batcher over the one executor: validate() guarantees the
        # dispatch bound, the fetch ring (>= 1) and one thread of headroom
        # (the solo fast path, monitor fetches) fit the pool.
        fetch_inflight = min(
            max_inflight, max(1, config.max_workers - max_inflight - 1)
        )
        self.batcher = MicroBatcher(
            engine,
            self._executor,
            window_ms=config.batch_window_ms,
            max_group=config.max_group,
            max_inflight=max_inflight,
            fetch_inflight=fetch_inflight,
            batch_mode=config.batch_mode,
            admit_fraction=config.batch_admit_fraction,
            wire_responses=True,
        )
        # SLO tier routing and brownout: armed only when asked for and the
        # engine holds a second tier. Pressure is the in-flight predict
        # depth over the dispatch capacity (max_inflight groups of
        # max_group requests).
        self.slo_routing = config.tier_routing and len(engine.available_tiers) > 1
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
        self._openapi: dict | None = None  # built once, on first request
        # Monitor telemetry: the request path only counts requests; the
        # aggregate is read off the hot path (after K requests, on the
        # timer, on scrapes) through one single-flight task.
        self._monitor_requests = 0
        self._monitor_task: asyncio.Task | None = None
        self._monitor_timer_task: asyncio.Task | None = None
        # Event-loop confined, like the fields above: touched only from
        # coroutines on the loop.
        self.draining = False
        self._connections: set[asyncio.StreamWriter] = set()
        self._busy: set[asyncio.StreamWriter] = set()

    async def start(self) -> asyncio.AbstractServer:
        if self.config.monitor_fetch_every_s > 0:
            self._monitor_timer_task = asyncio.get_running_loop().create_task(
                self._monitor_timer()
            )
        return await asyncio.start_server(
            self.handle_connection, self.config.host, self.config.port
        )

    def stop_telemetry(self) -> None:
        """Cancel the monitor timer and any fetch in flight."""
        for task in (self._monitor_timer_task, self._monitor_task):
            if task is not None and not task.done():
                task.cancel()

    def close(self) -> None:
        self._executor.shutdown(wait=True)

    # ------------------------------------------------------------- scoring
    async def _predict(self, body: bytes, request_id: str,
                       deadline: float | None, slo: int):
        records, errors = validate_records(body)
        if errors:
            return 422, {"detail": errors}
        if len(records) > self.max_batch:
            return 413, {
                "detail": f"batch of {len(records)} exceeds "
                f"max_batch={self.max_batch}"
            }
        if deadline is not None and asyncio.get_running_loop().time() >= deadline:
            # Expired at admission: no encode, no dispatch.
            self.metrics.count_deadline_expired()
            return deadline_response()
        name = self.config.service_name
        logger.info("%s", _LazyJson({
            "service_name": name, "type": "InferenceData",
            "request_id": request_id, "data": records,
        }))
        response = await self._score(records, request_id, deadline, slo)
        if isinstance(response, tuple):
            return response
        logger.info("%s", _LazyJson({
            "service_name": name, "type": "ModelOutput",
            "request_id": request_id, "data": response,
        }))
        return 200, response

    async def _score(self, records: list[dict], request_id: str,
                     deadline: float | None, slo: int):
        """Micro-batcher -> engine, with the deadline and failure
        contracts. ``slo`` maps to a tier, through the brownout governor
        first."""
        tier: str | None = None
        if self._brownout is not None:
            self._brownout.observe(self._score_inflight / self._score_capacity)
            routed, demoted = self._brownout.route(slo)
            tier = self.engine.route_tier(routed)
            self.metrics.count_tier(tier or self.engine.default_tier)
            if demoted:
                self.metrics.count_demotion(brownout=True)
        self._score_inflight += 1
        try:
            # The timeout exists for a stalled device; a client's deadline
            # budget tightens it per request and rides into the batcher, so
            # an expired entry is purged instead of dispatched.
            timeout = self.config.request_timeout_s or None
            if deadline is not None:
                remaining = deadline - asyncio.get_running_loop().time()
                timeout = min(timeout or remaining, remaining)
            call = self.batcher.predict(records, deadline=deadline, tier=tier)
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
            return deadline_response(
                f"prediction exceeded the {timeout:g}s deadline"
            )
        # Request boundary: any scoring failure (device error included)
        # becomes a logged 500, never a dropped connection.
        except Exception:
            logger.exception("prediction failed request_id=%s", request_id)
            return 500, {"detail": "prediction failed"}, "application/json"
        finally:
            self._score_inflight -= 1
        self._monitor_requests += 1
        self._maybe_fetch_monitor()
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
        self._monitor_requests = 0
        snapshot = await asyncio.get_running_loop().run_in_executor(
            self._executor, self.engine.monitor_snapshot
        )
        self.metrics.set_monitor_aggregate(snapshot)

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
        text = self.metrics.render(self.engine.dispatch_counts())
        return 200, text, "text/plain; version=0.0.4"

    async def _profile(self, action: str):
        if action not in ("start", "stop"):
            return 404, {"detail": "not found"}, "application/json"
        status, err = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._profiler.control, action
        )
        return profile_payload(status, action, self.config.profile_dir, err)

    # -------------------------------------------------------------- routes
    def _ready(self) -> bool:
        return bool(self.engine.ready) and not self.draining

    def _request_deadline(self, headers: dict[str, str]) -> float | None:
        """Absolute loop-clock deadline from a well-formed
        ``x-request-deadline-ms`` (positive ASCII digits), else None;
        malformed values are ignored, as the header is a hint."""
        raw = headers.get("x-request-deadline-ms", "")
        if raw and raw.isascii() and raw.isdigit() and int(raw) > 0:
            return asyncio.get_running_loop().time() + int(raw) / 1e3
        return None

    def _request_slo(self, headers: dict[str, str]) -> int:
        """The SLO class at admission: an explicit ``x-slo-class`` wins,
        else a deadline budget at or under ``slo_cheap_deadline_ms`` routes
        cheap; default when routing is off."""
        if not self.slo_routing:
            return SLO_DEFAULT
        raw = headers.get("x-request-deadline-ms", "")
        deadline_ms = (
            float(raw)
            if raw and raw.isascii() and raw.isdigit() and int(raw) > 0
            else None
        )
        return resolve_slo_class(
            headers.get("x-slo-class", ""), deadline_ms,
            self.config.slo_cheap_deadline_ms,
        )

    async def _route(self, method: str, path: str, body: bytes,
                     request_id: str, headers: dict[str, str]):
        if path == "/predict" and method == "POST":
            return await self._predict(
                body, request_id, self._request_deadline(headers),
                self._request_slo(headers),
            )
        if path.startswith("/debug/profile/") and method == "POST":
            return await self._profile(path.removeprefix("/debug/profile/"))
        if method == "GET":
            title = self.config.service_name
            if path == "/":
                return 200, SWAGGER_HTML.format(title=title), "text/html"
            if path == "/docs/plain":
                return 200, _DOCS_HTML.format(title=title), "text/html"
            if path == "/openapi.json":
                if self._openapi is None:
                    self._openapi = build_openapi(title)
                return 200, self._openapi
            if path == "/healthz":
                return health_verdict(self._ready())
            if path == "/healthz/live":
                return 200, {"status": "alive"}
            if path == "/healthz/ready":
                if self._ready():
                    return 200, {"status": "ready"}
                return 503, {"status": "warming"}
            if path == "/metrics":
                return await self._metrics_endpoint()
        return 404, {"detail": "not found"}

    # ---------------------------------------------------------- HTTP layer
    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._connections.add(writer)
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    break
                try:
                    method, path, _ = request_line.decode("latin1").split(" ", 2)
                except ValueError:
                    await self._write(writer, 400, {"detail": "bad request"}, False)
                    break
                headers: dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = line.decode("latin1").partition(":")
                    headers[name.strip().lower()] = value.strip()
                if "transfer-encoding" in headers:
                    await self._write(
                        writer, 400,
                        {"detail": "transfer-encoding not supported"}, False,
                    )
                    break
                raw_length = headers.get("content-length", "")
                if raw_length.isascii() and raw_length.isdigit():
                    length = int(raw_length)
                elif not raw_length:
                    length = 0
                else:
                    await self._write(
                        writer, 400, {"detail": "bad content-length"}, False
                    )
                    break
                if length > MAX_BODY_BYTES:
                    await self._write(
                        writer, 413,
                        {"detail": f"body exceeds {MAX_BODY_BYTES} bytes"},
                        False,
                    )
                    break
                body = await reader.readexactly(length) if length else b""
                keep_alive = (
                    headers.get("connection", "keep-alive") != "close"
                    and not self.draining
                )
                inbound = headers.get("x-request-id", "")
                request_id = (
                    inbound if _REQUEST_ID_RE.match(inbound)
                    else uuid.uuid4().hex
                )
                route = path.split("?", 1)[0]
                self._busy.add(writer)
                try:
                    status, payload, *ctype = await self._route(
                        method, route, body, request_id, headers
                    )
                    self.metrics.observe_request(route, status)
                    keep_alive = keep_alive and not self.draining
                    await self._write(
                        writer, status, payload, keep_alive, request_id,
                        ctype[0] if ctype else "application/json",
                    )
                finally:
                    self._busy.discard(writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._connections.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _write(
        self, writer, status: int, payload, keep_alive: bool = True,
        request_id: str | None = None, content_type: str = "application/json",
    ) -> None:
        if isinstance(payload, (dict, list)):
            body = json.dumps(payload, separators=(",", ":")).encode()
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = payload
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"content-type: {content_type}\r\n"
            f"content-length: {len(body)}\r\n"
        )
        if request_id:
            head += f"x-request-id: {request_id}\r\n"
        head += "connection: keep-alive\r\n\r\n" if keep_alive else (
            "connection: close\r\n\r\n"
        )
        writer.write(head.encode() + body)
        await writer.drain()

    def begin_drain(self, srv: asyncio.AbstractServer) -> None:
        """Stop accepting, report not-ready, close idle connections; busy
        exchanges finish their current response."""
        self.draining = True
        srv.close()
        for w in list(self._connections - self._busy):
            w.close()


async def serve(engine: InferenceEngine, config: ServeConfig) -> None:
    """Bind, warm up behind the socket, serve until SIGTERM, then drain."""
    server = HttpServer(engine, config)
    srv = await server.start()
    logger.info(
        "serving %s on %s:%s (tier=%s, tiers=%s, device=%s)",
        config.service_name, config.host, config.port, engine.serve_tier,
        ",".join(engine.available_tiers), engine.device,
    )
    loop = asyncio.get_running_loop()
    warmup_error: list[BaseException] = []

    async def _warm() -> None:
        try:
            await loop.run_in_executor(None, engine.warmup)
            logger.info("warmup complete; ready %s", _LazyJson(engine.warmup_stats))
        # A failed warmup (kernel build, launch, graph capture, OOM) stops
        # the server: the error is re-raised below, never left as a
        # forever-503.
        except Exception as err:
            warmup_error.append(err)
            logger.exception("warmup failed, shutting down")
            srv.close()

    def _drain() -> None:
        logger.info("SIGTERM: draining (no new connections)")
        server.begin_drain(srv)

    try:
        loop.add_signal_handler(signal.SIGTERM, _drain)
    except (NotImplementedError, RuntimeError, ValueError):
        pass  # not the main thread, or no signal support: no drain hook
    warm_task = loop.create_task(_warm())
    try:
        await srv.serve_forever()
    except asyncio.CancelledError:
        pass
    finally:
        srv.close()
        server.stop_telemetry()
        await warm_task
        deadline = loop.time() + config.drain_deadline_s
        while server._busy and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for w in list(server._connections):
            w.close()
        await loop.run_in_executor(None, server.close)
        logger.info("drained; exiting")
    if warmup_error:
        raise SystemExit(f"warmup failed: {warmup_error[0]}")


def serve_forever(engine: InferenceEngine, config: ServeConfig) -> None:
    """Blocking entry point."""
    asyncio.run(serve(engine, config))
