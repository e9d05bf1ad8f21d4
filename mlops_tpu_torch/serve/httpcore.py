"""Engine-free HTTP/1.1 core: the protocol, the routing skeleton and the
``POST /predict`` shell that every serving plane shares.

The port's counterpart of the JAX package's ``serve/httpcore.py``
(``HttpProtocol``): a process can parse, validate and answer HTTP here
without an engine or torch anywhere in sight. The single-process server
(``serve/server.py``) subclasses ``HttpProtocol`` against a live
``InferenceEngine``; the multi-worker front ends (``serve/frontend.py``)
subclass it against the shared-memory request ring (``serve/ipc.py``).
Both answer byte for byte alike: the same head, the same validation, the
same 422/413/504 answers and the same two structured log events.

``serve.log_sample_rate`` samples the reference's two-event log pair
(``InferenceData`` before scoring, ``ModelOutput`` after) under load, as
in the JAX package: a request that does not answer 200 always logs its
``InferenceData`` event, so errors are never sampled out.

The ``x-tenant`` header picks the tenant of a multi-tenant plane
(``tenancy/``): resolved before validation, an untagged request rides the
default tenant and an unknown name answers 404 with the JAX package's
body; its metrics bill the default tenant's row.

Observability, as in the JAX protocol: with a ``TraceRecorder`` installed
(``self.tracer``, tracing armed) every ``POST /predict`` carries a
``trace.Span`` whose trace id is the request id, stamped ``admission``
once validated and ``respond`` once the response is written, and
recorded; with a ``FlightRecorder`` (``self.flightrec``, SLOs armed)
every request is noted in its evidence ring. ``GET /healthz`` answers the
SLO verdict (``slo.health_verdict``) from ``_slo_view`` and
``_engine_down``. Disarmed, each costs one ``is None`` check.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import re
import time
import uuid
from typing import Any

from mlops_tpu_torch.config import ServeConfig
from mlops_tpu_torch.schema.validate import validate_records
from mlops_tpu_torch.serve.openapi import SWAGGER_HTML, build_openapi
from mlops_tpu_torch.serve.tierroute import SLO_DEFAULT, resolve_slo_class
from mlops_tpu_torch.serve.wire import deadline_response
from mlops_tpu_torch.slo.engine import health_verdict
from mlops_tpu_torch.tenancy.router import TenantRouter
from mlops_tpu_torch.trace.span import Span

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


class HttpProtocol:
    """Connection handling, head parsing, response writing, request ids,
    the docs / health routes, the ``POST /predict`` shell and the drain
    bookkeeping. Subclasses set ``self.metrics`` (anything with
    ``observe_request(route, status, latency_ms)`` and
    ``count_deadline_expired()``) and ``self.max_batch``, and implement
    ``_score``, ``_ready``, ``_metrics_endpoint`` and ``_profile``; a
    plane with SLOs armed overrides ``_slo_view`` (and ``_engine_down``).

    Every mutable field is event-loop confined: touched only from
    coroutines on the one asyncio thread, so none carries a lock."""

    # SLO tier routing: a subclass arms it where the serving side holds a
    # second tier.
    slo_routing = False

    def __init__(self, config: ServeConfig) -> None:
        self.config = config
        self.metrics: Any = None
        self.max_batch = config.max_batch
        self._openapi: dict | None = None  # built once, on first request
        self.draining = False
        self._connections: set[asyncio.StreamWriter] = set()
        self._busy: set[asyncio.StreamWriter] = set()
        # The ``x-tenant`` resolution: a subclass serving a fleet installs
        # its own; this is the one-tenant ("default") fleet.
        self.tenants = TenantRouter(())
        # Observability, installed by the plane's runner when armed: a
        # ``TraceRecorder`` and the span labels, and a ``FlightRecorder``.
        self.tracer: Any = None
        self.trace_plane = "single"
        self.trace_worker = 0
        self.flightrec: Any = None

    # ------------------------------------------------------ subclass hooks
    async def _score(self, records: list[dict], request_id: str,
                     deadline: float | None, slo: int, tenant: int = 0, span=None):
        """The response dict or its wire bytes, or a ``(status, payload,
        content_type[, headers])`` tuple for an error answer; ``tenant``
        is the request's tenant index, ``span`` its trace span (None when
        tracing is disarmed)."""
        raise NotImplementedError

    def _ready(self) -> bool:
        raise NotImplementedError

    def _slo_view(self):
        """The SLO view ``/healthz`` judges by (``slo.engine`` view shape);
        None with SLOs disarmed: the verdict follows readiness alone."""
        return None

    def _engine_down(self) -> bool:
        """A full engine outage (the ring plane's); never on the
        single-process plane, whose engine is this process."""
        return False

    async def _metrics_endpoint(self):
        raise NotImplementedError

    async def _profile(self, action: str):
        raise NotImplementedError

    # ------------------------------------------------------------- scoring
    async def _predict(self, body: bytes, request_id: str,
                       deadline: float | None, slo: int, tenant_raw: str = "",
                       span=None):
        """Resolve the tenant (404), validate (422), cap the batch (413),
        shed an expired budget (504), log ``InferenceData``, score, log
        ``ModelOutput``. ``span`` gets the ``admission`` stamp once the
        gates are behind."""
        tenant = self.tenants.resolve(tenant_raw)
        if tenant is None:
            return 404, {"detail": f"unknown tenant {tenant_raw[:64]!r}"}
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
        if span is not None:
            span.rows = len(records)
            span.stamp("admission")
        name = self.config.service_name
        rate = self.config.log_sample_rate
        sampled = rate >= 1.0 or random.random() < rate
        request_event = {
            "service_name": name, "type": "InferenceData",
            "request_id": request_id, "data": records,
        }
        if sampled:
            logger.info("%s", _LazyJson(request_event))
        response = await self._score(records, request_id, deadline, slo, tenant, span)
        if isinstance(response, tuple):
            # An error answer: an unsampled request logs its evidence now.
            if not sampled:
                logger.info("%s", _LazyJson(request_event))
            return response
        if sampled:
            logger.info("%s", _LazyJson({
                "service_name": name, "type": "ModelOutput",
                "request_id": request_id, "data": response,
            }))
        return 200, response

    # -------------------------------------------------------------- routes
    def _request_deadline(self, headers: dict[str, str]) -> float | None:
        """Absolute loop-clock deadline from a well-formed
        ``x-request-deadline-ms`` (positive ASCII digits), else None;
        malformed values are ignored, as the header is a hint. The loop
        clock is ``time.monotonic``, which the ring plane's engine process
        reads too."""
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
                     request_id: str, headers: dict[str, str], span=None):
        if path == "/predict" and method == "POST":
            return await self._predict(
                body, request_id, self._request_deadline(headers),
                self._request_slo(headers), headers.get("x-tenant", ""), span,
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
                return health_verdict(self._slo_view(), self._ready(),
                                      engine_down=self._engine_down())
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
                # The span's clock zero: the request head is in hand. One
                # clock read per request, only when tracing is armed.
                t_recv = time.monotonic() if self.tracer is not None else 0.0
                try:
                    method, path, _ = request_line.decode("latin1").split(" ", 2)
                except ValueError:
                    await self._write(writer, 400, {"detail": "bad request"}, False)
                    break
                headers: dict[str, str] = {}
                duplicate_length = False
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = line.decode("latin1").partition(":")
                    name = name.strip().lower()
                    # Two Content-Length lines would collapse last-wins
                    # here while an intermediary picks another one: the
                    # request-smuggling class, so refuse.
                    duplicate_length |= name == "content-length" and name in headers
                    headers[name] = value.strip()
                if duplicate_length:
                    await self._write(
                        writer, 400, {"detail": "duplicate content-length"}, False
                    )
                    break
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
                    start = time.perf_counter()
                    tenant_raw = headers.get("x-tenant", "")
                    tenant_bill = self.tenants.bill_label(tenant_raw)
                    span = None
                    if self.tracer is not None and route == "/predict" and method == "POST":
                        # The request id is the trace id: one identifier
                        # joins the two log events, the span record and
                        # the client's retry.
                        span = Span(trace_id=request_id, plane=self.trace_plane,
                                    worker=self.trace_worker, route=route, t0=t_recv,
                                    tenant=self.tenants.label(tenant_raw))
                    status, payload, *rest = await self._route(
                        method, route, body, request_id, headers, span
                    )
                    latency_ms = (time.perf_counter() - start) * 1e3
                    self.metrics.observe_request(route, status, latency_ms,
                                                 tenant=tenant_bill)
                    if self.flightrec is not None:
                        self.flightrec.observe_request(route, status, latency_ms,
                                                       tenant=tenant_bill,
                                                       request_id=request_id)
                    keep_alive = keep_alive and not self.draining
                    await self._write(
                        writer, status, payload, keep_alive, request_id,
                        rest[0] if rest else "application/json",
                        rest[1] if len(rest) > 1 else None,
                    )
                    if span is not None and not span.abandoned:
                        # Respond ends once the bytes are drained to the
                        # socket. An abandoned span (an engine call that
                        # outlived its deadline may still stamp it) is
                        # never finished.
                        span.stamp("respond")
                        record = span.finish(status)
                        self.tracer.record(record)
                        if self.flightrec is not None:
                            self.flightrec.note_span(record)
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
        extra_headers: dict[str, str] | None = None,
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
        for name, value in (extra_headers or {}).items():
            head += f"{name}: {value}\r\n"
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
