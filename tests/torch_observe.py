"""Helpers of the observability tests (``test_torch_trace.py``,
``test_torch_slo.py``): the single-process server of either package on an
event loop in a thread, armed the way each package's ``serve`` arms it
from the ``trace`` and ``slo`` config sections, and a raw HTTP client.

Both servers serve one bundle (``torch_ring.make_bundle``). The JAX
engine compiles each shape on first use, so the tests send the shapes
they need before the SLO engine's baseline is taken.
"""

from __future__ import annotations

import asyncio
import http.client
import re
import threading
from pathlib import Path

# The series this layer adds to /metrics (both planes, both packages).
OBSERVABILITY_FAMILIES = (
    "mlops_tpu_degraded_dispatch_total",
    "mlops_tpu_trace_dropped_total",
    "mlops_tpu_flightrec_dumps_total",
    "mlops_tpu_shape_occupancy",
    "mlops_tpu_requested_rows_total",
    "mlops_tpu_padded_rows_total",
    "mlops_tpu_padding_waste_pct",
    "mlops_tpu_useful_rows_per_s",
    "mlops_tpu_shape_table_evicted_total",
    "mlops_tpu_slo_good_total",
    "mlops_tpu_slo_total",
    "mlops_tpu_error_budget_remaining_pct",
    "mlops_tpu_slo_burn_rate",
    "mlops_tpu_alert_active",
    "mlops_tpu_entry_device_seconds_total",
    "mlops_tpu_entry_dispatch_total",
    "mlops_tpu_entry_rows_total",
    "mlops_tpu_entry_cost_ms_per_row",
)
_SAMPLE = re.compile(r"^([a-z_]+?)(_bucket|_sum|_count)?(\{[^}]*\})? \S+$")


def observability_labels(text: str) -> set[tuple[str, str]]:
    """(family, labels) of every sample of the observability families in
    a Prometheus text: the series set, values left out."""
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m is None:
            continue
        name = m.group(1) + (m.group(2) or "")
        family = next((f for f in OBSERVABILITY_FAMILIES
                       if name == f or name.startswith(f + "_")), None)
        if family is not None:
            out.add((name, m.group(3) or ""))
    return out


def metric(text: str, sample: str) -> float:
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no {sample} in /metrics")


def arm_jax(server, trace_dir: Path | None = None, slo=None, ledger_dir: Path | None = None):
    """The JAX ``serve/server.py::_serve`` wiring of the two sections."""
    from mlops_tpu.slo import CostLedger, FlightRecorder
    from mlops_tpu.trace import ShapeStats, TraceRecorder

    if trace_dir is not None:
        server.tracer = TraceRecorder(trace_dir / "spans.jsonl")
        stats = ShapeStats()
        for engine in server.engines:
            engine.set_shape_stats(stats)
    if slo is not None and slo.flightrec_enabled:
        server.flightrec = FlightRecorder(
            slo.flightrec_dir, capacity=slo.flightrec_capacity,
            cooldown_s=slo.flightrec_cooldown_s, keep=slo.flightrec_keep,
            source="single", spike_errors=slo.flightrec_spike_errors,
            spike_window_s=slo.flightrec_spike_window_s)
    if ledger_dir is not None:
        server.cost_ledger = CostLedger(ledger_dir)
        for engine in server.engines:
            engine.set_cost_ledger(server.cost_ledger)


def jax_slo_engine(server, slo):
    """The JAX SLO engine over a JAX server's counters (its baseline is
    taken now)."""
    from mlops_tpu.slo import SLOEngine

    names = tuple(server.tenants.names)
    return SLOEngine(slo, names,
                     source=lambda: server.metrics.slo_counts(slo.latency_threshold_ms, names),
                     on_alert=server.flightrec.note_alert if server.flightrec else None)


def port_slo_engine(server, slo):
    """The port's SLO engine over a port server's counters, as
    ``arm_observability`` builds it."""
    from mlops_tpu_torch.slo import SLOEngine

    names = tuple(server.tenants.names)
    return SLOEngine(slo, names,
                     source=lambda: server.metrics.slo_counts(slo.latency_threshold_ms, names),
                     on_alert=server.flightrec.note_alert if server.flightrec else None)


class LoopServer:
    """A constructed HttpServer of either package, started on an event
    loop in a thread on a free port."""

    def __init__(self, server) -> None:
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.srv = self.loop.run_until_complete(server.start())
        self.port = self.srv.sockets[0].getsockname()[1]
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def stop(self) -> None:
        def shutdown():
            self.server.stop_telemetry()
            self.srv.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(shutdown)
        self.thread.join(timeout=30)
        pending = asyncio.all_tasks(self.loop)
        for task in pending:
            task.cancel()

        async def settle():
            await asyncio.gather(*pending, return_exceptions=True)

        self.loop.run_until_complete(settle())
        self.loop.close()
        close = getattr(self.server, "close", None)  # the JAX server has none
        if close is not None:
            close()
        else:
            self.server._executor.shutdown(wait=True)
        for closer in (getattr(self.server, "tracer", None),
                       getattr(self.server, "cost_ledger", None)):
            if closer is not None:
                closer.close()
