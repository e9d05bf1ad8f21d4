"""Request tracing and shape telemetry for both serving planes: the
port's copy of the JAX package's ``trace/``.

- `Span` (span.py): one request's monotonic stage stamps — admission ->
  encode -> ring wait -> engine queue -> dispatch -> device fetch ->
  respond — stitched across the process boundary from the engine-half
  stamps the shared-memory slot carries (serve/ipc.py ``resp_trace``).
- `TraceRecorder` (recorder.py): a bounded, drop-counting buffer flushed
  to JSONL by a background writer.
- `ShapeStats` (shapes.py): per-entry shape histograms (requested rows
  vs padded rows) exported as Prometheus ``_bucket`` series plus the
  ``padding_waste_pct`` / ``useful_rows_per_s`` goodput gauges.
- `report.py`: ``python -m mlops_tpu_torch trace-report``'s aggregation,
  p50/p99 per stage per entry from the span JSONL.

The vocabulary, the record fields and the series names are the JAX
package's, so a span file written by either package reads in the other's
``trace-report``. Nothing here imports torch (front-end processes import
it) and everything is gated behind the ``trace`` config section:
disarmed, the serving hot path pays one ``is None`` check per request.
"""

from mlops_tpu_torch.trace.recorder import TraceRecorder
from mlops_tpu_torch.trace.report import format_report, load_spans, stage_report
from mlops_tpu_torch.trace.shapes import ShapeStats
from mlops_tpu_torch.trace.span import Span

__all__ = [
    "Span",
    "TraceRecorder",
    "ShapeStats",
    "load_spans",
    "stage_report",
    "format_report",
]
