"""Fleet health for both serving planes: the port's copy of the JAX
package's ``slo/``. Nothing here imports torch.

- `engine.SLOEngine` — availability and latency SLOs per tenant,
  evaluated from the request counters into multi-window multi-burn-rate
  gauges, alert flags and a ``/healthz`` verdict. The repo's shipped
  Prometheus rules (``configs/alerts/``) read its series.
- `flightrec.FlightRecorder` — a bounded ring of recent request summaries
  and spans, dumped atomically to ``<dir>/flightrec-*.json`` on an
  anomaly (a burn alert, an engine respawn, a 5xx/504 spike, a breaker
  opening) and on SIGTERM with evidence.
- `ledger.CostLedger` — per-entry device-path time, dispatches and rows,
  keyed by entry and model fingerprint and accumulated across runs on
  disk.

Disarmed, every hot path pays one ``is None`` check.
"""

from mlops_tpu_torch.slo.engine import (  # noqa: F401
    ENGINE_ALERTS,
    SLO_NAMES,
    SLOEngine,
    health_verdict,
    render_slo_lines,
)
from mlops_tpu_torch.slo.flightrec import FlightRecorder  # noqa: F401
from mlops_tpu_torch.slo.ledger import CostLedger, ledger_report  # noqa: F401
