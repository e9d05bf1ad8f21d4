"""A small asyncio HTTP/1.1 server for the engine (exact or quant tier).

The JAX package's single-process plane (``serve/httpcore.py`` +
``serve/server.py``) cut down to this slice's routes:

- ``POST /predict`` — validate (422), cap the batch (413), log the
  reference's two structured events (``InferenceData`` before scoring,
  ``ModelOutput`` after), score in a thread pool, answer 200 with the
  reference response body;
- ``GET /healthz/live`` and ``GET /healthz/ready`` (503 until warmup is
  done, and again once draining);
- ``GET /metrics`` — request counters, the monitor aggregate (fetched
  fresh from the device on each scrape) and the kernel launch count.

The socket binds first and warmup runs behind it, so probes answer while
the engine warms. SIGTERM drains: no new connections, idle ones closed,
busy exchanges finish their response.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import re
import signal
import threading
import uuid
from typing import Any

from mlops_tpu_torch.config import ServeConfig
from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
from mlops_tpu_torch.schema.validate import validate_records
from mlops_tpu_torch.serve.engine import InferenceEngine

logger = logging.getLogger("mlops_tpu_torch.serve")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 422: "Unprocessable Entity",
            500: "Internal Server Error", 503: "Service Unavailable"}
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")
MAX_BODY_BYTES = 16 * 1024 * 1024


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


class Metrics:
    """Request counters by (route, status); rendered with the monitor
    snapshot in Prometheus text format, under the reference's series
    names."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests: dict[tuple[str, int], int] = {}

    def observe_request(self, route: str, status: int) -> None:
        with self._lock:
            key = (route, status)
            self.requests[key] = self.requests.get(key, 0) + 1

    def render(self, monitor: dict[str, Any]) -> str:
        t = 'tenant="default"'
        lines = ["# TYPE mlops_tpu_requests_total counter"]
        with self._lock:
            for (route, status), count in sorted(self.requests.items()):
                lines.append(
                    f'mlops_tpu_requests_total{{route="{route}",'
                    f'status="{status}",{t}}} {count}'
                )
        lines += [
            "# TYPE mlops_tpu_rows_scored_total counter",
            f"mlops_tpu_rows_scored_total{{{t}}} {monitor['rows']}",
            "# TYPE mlops_tpu_outliers_total counter",
            f"mlops_tpu_outliers_total{{{t}}} {monitor['outliers']}",
            "# TYPE mlops_tpu_monitor_batches_total counter",
            f"mlops_tpu_monitor_batches_total{{{t}}} {monitor['batches']}",
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
            "# TYPE mlops_tpu_kernel_launches_total counter",
            'mlops_tpu_kernel_launches_total{kernel="quant_fused"} '
            f"{quant_kernel_launches.value}",
        ]
        return "\n".join(lines) + "\n"


class HttpServer:
    def __init__(self, engine: InferenceEngine, config: ServeConfig):
        self.engine = engine
        self.config = config
        self.metrics = Metrics()
        self.max_batch = min(config.max_batch, engine.max_bucket)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=config.max_workers, thread_name_prefix="predict"
        )
        # Event-loop confined: touched only from coroutines on the loop.
        self.draining = False
        self._connections: set[asyncio.StreamWriter] = set()
        self._busy: set[asyncio.StreamWriter] = set()

    async def start(self) -> asyncio.AbstractServer:
        return await asyncio.start_server(
            self.handle_connection, self.config.host, self.config.port
        )

    def close(self) -> None:
        self._executor.shutdown(wait=True)

    # -------------------------------------------------------------- routes
    async def _predict(self, body: bytes, request_id: str):
        records, errors = validate_records(body)
        if errors:
            return 422, {"detail": errors}
        if len(records) > self.max_batch:
            return 413, {
                "detail": f"batch of {len(records)} exceeds "
                f"max_batch={self.max_batch}"
            }
        name = self.config.service_name
        logger.info("%s", _LazyJson({
            "service_name": name, "type": "InferenceData",
            "request_id": request_id, "data": records,
        }))
        loop = asyncio.get_running_loop()
        try:
            response = await loop.run_in_executor(
                self._executor, self.engine.predict_records_wire, records
            )
        # Request boundary: any scoring failure (device error included)
        # becomes a logged 500, never a dropped connection.
        except Exception:
            logger.exception("prediction failed request_id=%s", request_id)
            return 500, {"detail": "prediction failed"}
        logger.info("%s", _LazyJson({
            "service_name": name, "type": "ModelOutput",
            "request_id": request_id, "data": response,
        }))
        return 200, response

    async def _metrics_endpoint(self):
        loop = asyncio.get_running_loop()
        snapshot = await loop.run_in_executor(
            self._executor, self.engine.monitor_snapshot
        )
        return 200, self.metrics.render(snapshot), "text/plain; version=0.0.4"

    async def _route(self, method: str, path: str, body: bytes, request_id: str):
        if path == "/predict" and method == "POST":
            return await self._predict(body, request_id)
        if method == "GET":
            if path == "/healthz/live":
                return 200, {"status": "alive"}
            if path == "/healthz/ready":
                if self.engine.ready and not self.draining:
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
                        method, route, body, request_id
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
        "serving %s on %s:%s (tier=%s, device=%s)", config.service_name,
        config.host, config.port, engine.serve_tier, engine.device,
    )
    loop = asyncio.get_running_loop()
    warmup_error: list[BaseException] = []

    async def _warm() -> None:
        try:
            await loop.run_in_executor(None, engine.warmup)
            logger.info("warmup complete; ready %s", _LazyJson(engine.warmup_stats))
        # A failed warmup (kernel build, launch, OOM) stops the server:
        # the error is re-raised below, never left as a forever-503.
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
