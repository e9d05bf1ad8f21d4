"""Measured per-entry dispatch cost model — the gridtuner's physics.

A copy of the JAX package's ``autotune/costmodel.py``, torch-free by
construction like ``slo/`` and ``trace/``: the model is fit from the device-time cost
ledger (slo/ledger.py — per-entry ``device_s / dispatches / rows /
padded_rows``), optionally refined by span history, and consumed by the
grid search (autotune/search.py). Everything here is plain arithmetic
over telemetry the plane already exports.

The model is AFFINE in padded rows: ``dispatch_s(p) = a + b*p``. That
shape is the whole economics of bucketing — ``a`` is the fixed
per-dispatch overhead (graph replay, host round trip, accumulator
chain) that punishes grids with too many tiny buckets, ``b`` is the
per-padded-row device cost that punishes grids that pad too much. Both
are FIT from ledger observations at the warmed bucket sizes (weighted
least squares, dispatch-count weights); with fewer than two distinct
observed sizes the fit degenerates and we fall back to a
measured-affine split of the one observed mean cost
(``MEASURED_OVERHEAD_FRACTION`` of it as overhead) — still anchored to
a measurement, never a guess about absolute speed.
"""

from __future__ import annotations

import dataclasses
import re

# Measured-affine fallback: with a single observed bucket size the
# overhead/slope split is unidentifiable, so treat this fraction of the
# observed mean dispatch cost as fixed overhead and amortize the rest
# per padded row. The absolute scale stays measured; only the split is
# assumed (and recorded in the plan via CostModel.mode for the audit).
MEASURED_OVERHEAD_FRACTION = 0.25

_BUCKET_ENTRY = re.compile(r"^bucket_(\d+)$")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """``dispatch_s(padded_rows) = a_s + b_s * padded_rows``."""

    a_s: float  # fixed per-dispatch overhead, seconds
    b_s: float  # marginal cost per padded row, seconds
    points: int  # distinct bucket sizes the fit saw
    mode: str  # "affine-fit" | "measured-affine"

    def dispatch_s(self, padded_rows: float) -> float:
        return self.a_s + self.b_s * float(padded_rows)

    def as_dict(self) -> dict:
        return {
            "a_s": self.a_s,
            "b_s": self.b_s,
            "points": self.points,
            "mode": self.mode,
        }


def ledger_rows_from_snapshot(snapshot: dict) -> list[dict]:
    """Normalize a LIVE ledger snapshot (`CostLedger.snapshot()`:
    ``<entry>@<tag>`` -> [device_s, dispatches, rows, padded_rows]) into
    the same row dicts `slo.ledger.ledger_report` produces offline, so
    the fit consumes one shape from either plane. Model tags are folded
    away: the autotuner grids the PLANE, and the ledger keys only split
    tags so promotions don't cross-pollute history — here the union IS
    the observed traffic."""
    merged: dict[str, list[float]] = {}
    for key, vals in snapshot.items():
        entry = key.rsplit("@", 1)[0] if "@" in key else key
        acc = merged.setdefault(entry, [0.0, 0.0, 0.0, 0.0])
        for i in range(4):
            acc[i] += float(vals[i])
    return [
        {
            "entry": entry,
            "device_s": acc[0],
            "dispatches": acc[1],
            "rows": acc[2],
            "padded_rows": acc[3],
        }
        for entry, acc in sorted(merged.items())
    ]


def bucket_cost_points(
    ledger_rows: list[dict],
) -> list[tuple[int, float, float]]:
    """Per observed SOLO bucket size: ``(size, mean_dispatch_s,
    dispatch_weight)``. Group entries are excluded on purpose — the
    grouped path's geometry is the fixed module-constant grid
    (serve/wire.py), not part of the search space, and its fused
    multi-request dispatches would bias the solo overhead estimate."""
    points: list[tuple[int, float, float]] = []
    for row in ledger_rows:
        m = _BUCKET_ENTRY.match(str(row.get("entry", "")))
        if not m:
            continue
        dispatches = float(row.get("dispatches", 0.0))
        if dispatches <= 0:
            continue
        points.append(
            (
                int(m.group(1)),
                float(row.get("device_s", 0.0)) / dispatches,
                dispatches,
            )
        )
    points.sort()
    return points


def fit_cost_model(ledger_rows: list[dict]) -> CostModel | None:
    """Weighted least-squares affine fit over the observed bucket cost
    points; measured-affine fallback below two distinct sizes; None with
    no solo observations at all (the caller holds — no model, no plan)."""
    points = bucket_cost_points(ledger_rows)
    if not points:
        return None
    if len(points) == 1:
        size, cost, _w = points[0]
        a = cost * MEASURED_OVERHEAD_FRACTION
        return CostModel(
            a_s=a, b_s=(cost - a) / max(size, 1), points=1,
            mode="measured-affine",
        )
    sw = sum(w for _, _, w in points)
    sx = sum(s * w for s, _, w in points)
    sy = sum(c * w for _, c, w in points)
    sxx = sum(s * s * w for s, _, w in points)
    sxy = sum(s * c * w for s, c, w in points)
    det = sw * sxx - sx * sx
    if det <= 0:
        return None
    b = (sw * sxy - sx * sy) / det
    a = (sy - b * sx) / sw
    if b <= 0 or a < 0:
        # A noisy fit with non-physical coefficients (bigger buckets
        # measured cheaper, negative overhead) would make the search
        # prefer maximal padding — degrade to the measured-affine split
        # of the dispatch-weighted mean instead of optimizing noise.
        mean_cost = sy / sw
        mean_size = sx / sw
        a = mean_cost * MEASURED_OVERHEAD_FRACTION
        return CostModel(
            a_s=a, b_s=(mean_cost - a) / max(mean_size, 1.0),
            points=len(points), mode="measured-affine",
        )
    return CostModel(a_s=a, b_s=b, points=len(points), mode="affine-fit")


# Occupancy histogram edges — MUST mirror trace/shapes.OCCUPANCY_BUCKETS
# (imported lazily in demand_from_shapes to keep this module standalone
# for the offline CLI; the import asserts the mirror).


def demand_from_shapes(shape_entries: dict) -> list[tuple[int, float]]:
    """Reconstruct the requested-rows distribution from ShapeStats
    entries (``{entry: [dispatches, requested, padded, hist...]}``):
    weighted points ``(requested_rows, dispatches)``.

    Per solo entry ``bucket_B``, occupancy bin (lo, hi] holding ``n``
    dispatches contributes a point at ``B * (lo+hi)/2`` requested rows
    — then every entry's points are rescaled so their weighted sum
    matches the entry's EXACT requested-rows counter (the histogram
    bounds the granularity; the counters pin the mass). Group entries
    are excluded (fixed geometry, see bucket_cost_points)."""
    from mlops_tpu_torch.trace.shapes import OCCUPANCY_BUCKETS

    edges = (0.0,) + tuple(OCCUPANCY_BUCKETS)
    demand: list[tuple[int, float]] = []
    for entry, vals in shape_entries.items():
        m = _BUCKET_ENTRY.match(str(entry))
        if not m:
            continue
        size = int(m.group(1))
        dispatches = float(vals[0])
        requested = float(vals[1])
        hist = [float(x) for x in vals[3:3 + len(OCCUPANCY_BUCKETS)]]
        if dispatches <= 0 or sum(hist) <= 0:
            continue
        points = []
        for i, count in enumerate(hist):
            if count <= 0:
                continue
            rep = size * (edges[i] + edges[i + 1]) / 2.0
            points.append([max(1, int(round(rep))), count])
        approx = sum(r * w for r, w in points)
        if approx > 0 and requested > 0:
            scale = requested / approx
            points = [
                [max(1, min(size, int(round(r * scale)))), w]
                for r, w in points
            ]
        demand.extend((r, w) for r, w in points)
    # Merge duplicate sizes across entries (keeps the search DP small).
    merged: dict[int, float] = {}
    for r, w in demand:
        merged[r] = merged.get(r, 0.0) + w
    return sorted(merged.items())


def demand_from_spans(spans: list[dict]) -> list[tuple[int, float]]:
    """Offline demand from span history (trace/report.load_spans):
    every solo-entry span's exact requested ``rows`` is one unit-weight
    point — finer-grained than the occupancy-histogram reconstruction,
    used by `mlops-tpu autotune` when span files are available."""
    merged: dict[int, float] = {}
    for span in spans:
        if not _BUCKET_ENTRY.match(str(span.get("entry", ""))):
            continue
        rows = int(span.get("rows", 0))
        if rows <= 0:
            continue
        merged[rows] = merged.get(rows, 0.0) + 1.0
    return sorted(merged.items())
