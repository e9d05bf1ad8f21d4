"""The ring plane's Prometheus exposition, rendered from shared memory,
and the lifecycle block both planes share.

The ring subset of the JAX package's ``serve/metrics.py``
(``render_ring_metrics``): every front end renders the whole plane from
the shared-memory ring (``serve/ipc.py``), so whichever of the
``SO_REUSEPORT`` workers answers a scrape shows every worker and the
engine process. Under the JAX package's series names:

- per worker: request counters and the latency histogram (JAX's
  ``LATENCY_BUCKETS``), ring depth and sheds per slot class;
- the monitor aggregate, which the engine process's telemetry loop
  writes (a front end never touches the device);
- the dead-work sheds (``mlops_tpu_deadline_expired_total``), the
  survivability block (engine respawns and incarnation, replayed slots,
  monitor rows lost with a dead engine, parked requests, brownout sheds)
  and the port's ``mlops_tpu_engine_down_since``;
- the tier and demotion counters;
- the port's two series of the single-process plane: dispatches per
  program (``mlops_tpu_dispatches_total{entry=...}``) and
  ``mlops_tpu_kernel_launches_total``, counted in the engine process and
  mirrored into shared memory.

``lifecycle_lines`` is the JAX ``ServingMetrics.lifecycle_lines``: the
lifecycle controller's gauges (bundle generation, drift triggers, shadow
AUC delta, promotions by outcome, reservoir rows, circuit breaker), byte
for byte the JAX render of the same snapshot. The single-process server
renders it under ``lifecycle.enabled=true``; on the ring plane the engine
process's telemetry loop writes the controller's snapshot into the
ring's lifecycle row (``RequestRing.write_lifecycle``) and every front
end renders it from there, as the JAX ring render does. Tracing, the SLO
engine, the cost ledger and the autotuner are not ported (ROADMAP A4),
nor their series.
"""

from __future__ import annotations

import time

from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.tierroute import TIERS

LATENCY_BUCKETS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 1000, float("inf"))
# Known routes only: arbitrary request paths must not become unbounded
# label values; anything else counts as "<other>".
KNOWN_ROUTES = (
    "/predict", "/", "/healthz", "/healthz/live", "/healthz/ready", "/metrics",
)
ROUTES = KNOWN_ROUTES + ("<other>",)
# The closed status set of the request matrices; anything else lands in
# a catch-all column rendered as status="other".
RING_STATUSES = (200, 400, 404, 409, 413, 422, 500, 503, 504)
RING_CLASSES = ("small", "large")
TENANT = "default"
# Promotion outcomes, in the JAX package's order.
LIFE_OUTCOMES = ("promoted", "rejected", "rolled_back")
# Fields of the ring's lifecycle row (engine-process single writer; see
# RequestRing.write_lifecycle). The AUC delta rides two fields, value and
# has-flag, because 0.0 is a delta and not "unknown".
(
    LIFE_GENERATION,
    LIFE_TRIGGERS,
    LIFE_AUC_DELTA,
    LIFE_HAS_DELTA,
    LIFE_RESERVOIR,
    LIFE_HAS,
    LIFE_BREAKER_OPEN,
    LIFE_BREAKER_TRIPS,
) = range(8)
# Fields of the monitor-aggregate row (engine-process single writer).
MON_ROWS, MON_OUTLIERS, MON_BATCHES, MON_FETCHES, MON_FETCHED_AT, MON_HAS = range(6)
# Fields of the engine-supervision row. The engine process writes
# INCARNATION, REPLAYED, ROWS_LOST, ROWS_DISPATCHED and EXPIRED; the
# supervisor DOWN_SINCE (cleared by the engine at ready) and RESPAWNS.
(
    ENG_INCARNATION,
    ENG_DOWN_SINCE,
    ENG_RESPAWNS,
    ENG_REPLAYED,
    ENG_ROWS_LOST,
    ENG_ROWS_DISPATCHED,
    ENG_EXPIRED,
) = range(7)


def _counter(name: str, value) -> list[str]:
    return [f"# TYPE {name} counter", f"{name} {value}"]


def lifecycle_lines(snapshot: dict | None, tenant: str = TENANT) -> list[str]:
    """The lifecycle gauge block for one controller
    (``LifecycleController.metrics_snapshot``); empty without one."""
    if not snapshot:
        return []
    t = f'tenant="{tenant}"'
    lines = [
        "# TYPE mlops_tpu_bundle_generation gauge",
        f"mlops_tpu_bundle_generation{{{t}}} {int(snapshot['generation'])}",
        "# TYPE mlops_tpu_drift_trigger_total counter",
        f"mlops_tpu_drift_trigger_total{{{t}}} {int(snapshot['drift_triggers'])}",
    ]
    delta = snapshot.get("shadow_auc_delta")
    if delta is not None:
        lines.append("# TYPE mlops_tpu_shadow_auc_delta gauge")
        lines.append(f"mlops_tpu_shadow_auc_delta{{{t}}} {float(delta):.6f}")
    lines.append("# TYPE mlops_tpu_promotions_total counter")
    promotions = snapshot.get("promotions", {})
    for outcome in LIFE_OUTCOMES:
        lines.append(
            f'mlops_tpu_promotions_total{{{t},outcome="{outcome}"}} '
            f"{int(promotions.get(outcome, 0))}"
        )
    rows = snapshot.get("reservoir_rows")
    if rows is not None:
        lines.append("# TYPE mlops_tpu_lifecycle_reservoir_rows gauge")
        lines.append(f"mlops_tpu_lifecycle_reservoir_rows{{{t}}} {int(rows)}")
    if "breaker_open" in snapshot:
        lines.append("# TYPE mlops_tpu_lifecycle_breaker_open gauge")
        lines.append(
            f"mlops_tpu_lifecycle_breaker_open{{{t}}} "
            f"{1 if snapshot['breaker_open'] else 0}"
        )
        lines.append("# TYPE mlops_tpu_lifecycle_breaker_trips_total counter")
        lines.append(
            f"mlops_tpu_lifecycle_breaker_trips_total{{{t}}} "
            f"{int(snapshot.get('breaker_trips', 0))}"
        )
    return lines


def render_ring_metrics(ring) -> str:
    """Prometheus text for the whole ring plane, from ``ring``'s shared
    memory alone."""
    t = f'tenant="{TENANT}"'
    lines = ["# TYPE mlops_tpu_requests_total counter"]
    for w in range(ring.workers):
        for r_i, route in enumerate(ROUTES):
            row = ring.req_counts[w, r_i]
            for s_i, status in enumerate((*RING_STATUSES, "other")):
                if int(row[s_i]):
                    lines.append(
                        f'mlops_tpu_requests_total{{route="{route}",'
                        f'status="{status}",worker="{w}",{t}}} {int(row[s_i])}'
                    )
    lines.append("# TYPE mlops_tpu_request_latency_ms histogram")
    for w in range(ring.workers):
        cumulative = 0
        for edge, count in zip(LATENCY_BUCKETS, ring.lat_counts[w]):
            cumulative += int(count)
            label = "+Inf" if edge == float("inf") else str(edge)
            lines.append(
                f'mlops_tpu_request_latency_ms_bucket{{le="{label}",'
                f'worker="{w}",{t}}} {cumulative}'
            )
        lines.append(
            f'mlops_tpu_request_latency_ms_sum{{worker="{w}",{t}}} '
            f"{float(ring.lat_sum_ms[w])}"
        )
        lines.append(
            f'mlops_tpu_request_latency_ms_count{{worker="{w}",{t}}} '
            f"{int(ring.lat_n[w])}"
        )
    # Every worker's depth and shed series, always: a scrape proves each
    # worker exists even before it served traffic.
    for name, cells in (("mlops_tpu_ring_depth", ring.inflight),
                        ("mlops_tpu_shed_total", ring.shed)):
        kind = "gauge" if name.endswith("depth") else "counter"
        lines.append(f"# TYPE {name} {kind}")
        for w in range(ring.workers):
            for c_i, cls in enumerate(RING_CLASSES):
                lines.append(
                    f'{name}{{worker="{w}",class="{cls}",{t}}} '
                    f"{int(cells[w, c_i])}"
                )
    mon = ring.mon_vals
    lines += [
        "# TYPE mlops_tpu_rows_scored_total counter",
        f"mlops_tpu_rows_scored_total{{{t}}} {int(mon[MON_ROWS])}",
        "# TYPE mlops_tpu_outliers_total counter",
        f"mlops_tpu_outliers_total{{{t}}} {int(mon[MON_OUTLIERS])}",
    ]
    if mon[MON_HAS]:
        for name, values in (("mlops_tpu_feature_drift_score", ring.mon_drift_last),
                             ("mlops_tpu_feature_drift_mean", ring.mon_drift_mean)):
            lines.append(f"# TYPE {name} gauge")
            for feature, score in zip(SCHEMA.feature_names, values):
                lines.append(f'{name}{{feature="{feature}",{t}}} {float(score)}')
        lines += _counter("mlops_tpu_monitor_fetches_total", int(mon[MON_FETCHES]))
        lines += [
            "# TYPE mlops_tpu_monitor_batches_total counter",
            f"mlops_tpu_monitor_batches_total{{{t}}} {int(mon[MON_BATCHES])}",
            "# TYPE mlops_tpu_monitor_fetch_age_seconds gauge",
            "mlops_tpu_monitor_fetch_age_seconds "
            f"{time.monotonic() - float(mon[MON_FETCHED_AT]):.3f}",
        ]
    eng = ring.eng_vals
    lines += _counter(
        "mlops_tpu_deadline_expired_total",
        int(ring.expired.sum()) + int(eng[ENG_EXPIRED]),
    )
    lines += _counter("mlops_tpu_engine_respawn_total", int(eng[ENG_RESPAWNS]))
    lines += _counter("mlops_tpu_replayed_slots_total", int(eng[ENG_REPLAYED]))
    lines += _counter("mlops_tpu_monitor_rows_lost_total", int(eng[ENG_ROWS_LOST]))
    lines += [
        "# TYPE mlops_tpu_parked_requests gauge",
        f"mlops_tpu_parked_requests {int(ring.parked.sum())}",
    ]
    lines += _counter("mlops_tpu_brownout_shed_total", int(ring.brownout_shed.sum()))
    lines += [
        "# TYPE mlops_tpu_engine_incarnation gauge",
        f"mlops_tpu_engine_incarnation {int(eng[ENG_INCARNATION])}",
        # The monotonic time the supervisor saw the engine die; 0 while
        # an engine is up.
        "# TYPE mlops_tpu_engine_down_since gauge",
        f"mlops_tpu_engine_down_since {float(eng[ENG_DOWN_SINCE])}",
        "# TYPE mlops_tpu_tier_requests_total counter",
    ]
    for i, tier in enumerate(TIERS):
        lines.append(
            f'mlops_tpu_tier_requests_total{{tier="{tier}"}} '
            f"{int(ring.tier_counts[i])}"
        )
    lines += _counter("mlops_tpu_tier_demotions_total", int(ring.tier_demote.sum()))
    lines += _counter("mlops_tpu_brownout_demote_total",
                      int(ring.brownout_demote.sum()))
    lines.append("# TYPE mlops_tpu_dispatches_total counter")
    for entry, count in sorted(ring.dispatch_counts().items()):
        lines.append(f'mlops_tpu_dispatches_total{{entry="{entry}"}} {count}')
    lines += [
        "# TYPE mlops_tpu_kernel_launches_total counter",
        'mlops_tpu_kernel_launches_total{kernel="quant_fused"} '
        f"{int(ring.kernel_launches[0])}",
    ]
    life = ring.life_vals
    if life[LIFE_HAS]:
        # The engine process's loop state, rebuilt as a snapshot so the
        # one formatter renders it on both planes.
        lines += lifecycle_lines({
            "generation": int(life[LIFE_GENERATION]),
            "drift_triggers": int(life[LIFE_TRIGGERS]),
            "shadow_auc_delta": (float(life[LIFE_AUC_DELTA])
                                 if life[LIFE_HAS_DELTA] else None),
            "promotions": {outcome: int(ring.life_promos[i])
                           for i, outcome in enumerate(LIFE_OUTCOMES)},
            "reservoir_rows": int(life[LIFE_RESERVOIR]),
            "breaker_open": bool(life[LIFE_BREAKER_OPEN]),
            "breaker_trips": int(life[LIFE_BREAKER_TRIPS]),
        })
    return "\n".join(lines) + "\n"
