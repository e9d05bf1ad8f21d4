"""The ring plane's Prometheus exposition, rendered from shared memory,
and the lifecycle block both planes share.

The ring subset of the JAX package's ``serve/metrics.py``
(``render_ring_metrics``): every front end renders the whole plane from
the shared-memory ring (``serve/ipc.py``), so whichever of the
``SO_REUSEPORT`` workers answers a scrape shows every worker, every
engine replica and every tenant. Under the JAX package's series names:

- per worker and tenant: request counters and the latency histogram
  (JAX's ``LATENCY_BUCKETS``), ring depth and sheds per slot class, and
  the sheds of each tenant's own quota
  (``mlops_tpu_tenant_quota_shed_total``);
- the monitor aggregate per tenant, which each replica's telemetry loop
  writes into its own rows (a front end never touches the device),
  folded over the replicas;
- the dead-work sheds (``mlops_tpu_deadline_expired_total``), the
  survivability block (respawns and incarnations, replayed slots, monitor
  rows lost with a dead replica, parked requests, brownout sheds) summed
  over the replicas, and the port's ``mlops_tpu_engine_down_since``;
- the tier and demotion counters;
- the per-replica block: ``mlops_tpu_replica_ready``, ``_ring_depth``,
  ``_incarnation``, ``_respawn_total``, ``_replayed_slots_total`` and
  ``_rows_scored_total``, every replica on every scrape;
- the port's two series of the single-process plane: dispatches per
  program (``mlops_tpu_dispatches_total{entry=...}``) and
  ``mlops_tpu_kernel_launches_total``, counted in each replica process and
  summed over the replicas' rows.

``lifecycle_lines`` is the JAX ``ServingMetrics.lifecycle_lines``: one
tenant's lifecycle controller gauges (bundle generation, drift triggers,
shadow AUC delta, promotions by outcome, reservoir rows, circuit
breaker), byte for byte the JAX render of the same snapshot. The
single-process server renders one block per tenant under
``lifecycle.enabled=true``; on the ring plane the engine process's
telemetry loop writes each controller's snapshot into its tenant's row
(``RequestRing.write_lifecycle``) and every front end renders it from
there, as the JAX ring render does.

Observability (``trace/``, ``slo/``), on both planes under the JAX
series names: ``robustness_lines`` (dead-work sheds, degraded dispatches,
dropped spans, flight-recorder dumps) always; with tracing armed the
shape histograms each replica's telemetry thread mirrors
(``shape_keys``/``shape_vals``), merged by entry; with SLOs armed the
SLO and alert block the lead replica mirrors (``slo_vals``/
``alert_vals``), ``engine_down`` computed by whoever renders; with
``slo.ledger_dir`` the cost ledger's ``mlops_tpu_entry_*`` series, merged
by entry.

``autotune_lines`` is the JAX ``ServingMetrics.autotune_lines``: the
autotuner's plane-level block (``mlops_tpu_grid_generation``, plans by
outcome, the predicted and measured gains), byte for byte the JAX render
of the same snapshot. On the ring plane each replica's telemetry loop
writes its controller's snapshot into its row (``auto_vals`` /
``auto_plans``) and the render folds the rows as the JAX ring render
does: the grid generation is the MIN over armed replicas (it moves once
every sibling adopted the lead's plan), plans sum, the gains are the
lead's.
"""

from __future__ import annotations

import time

from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.tierroute import TIERS
from mlops_tpu_torch.slo import ledger as _ledger
from mlops_tpu_torch.slo.engine import read_slo_view, render_slo_lines
from mlops_tpu_torch.trace import shapes as _shapes

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
# Statuses that spend the availability SLO's budget (any 5xx does).
SLO_BAD_STATUSES = (500, 503, 504)
DEFAULT_TENANT_LABEL = "default"
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
# Autotune plan outcomes, in the JAX package's order: applied = a regrid
# landed; planned = a dry-run winner persisted, not applied; rejected =
# below min_gain_pct or already optimal; rolled_back = the operator's
# bail-out; failed = a tick error or a promotion that raced the warm.
AUTOTUNE_OUTCOMES = ("applied", "planned", "rejected", "rolled_back", "failed")
# Fields of the ring's per-replica autotune row (that replica's telemetry
# loop writes it; see RequestRing.write_autotune). Gains ride value and
# has-flag pairs: 0.0 is a gain, not "no audit yet".
(
    AUTO_GRID_GEN,
    AUTO_PRED_GAIN,
    AUTO_HAS_PRED,
    AUTO_MEAS_GAIN,
    AUTO_HAS_MEAS,
    AUTO_HAS,
) = range(6)
# Fields of the monitor-aggregate row (engine-process single writer).
MON_ROWS, MON_OUTLIERS, MON_BATCHES, MON_FETCHES, MON_FETCHED_AT, MON_HAS = range(6)
# Fields of the engine-supervision row. The engine process writes
# INCARNATION, REPLAYED, ROWS_LOST, ROWS_DISPATCHED, EXPIRED and DEGRADED;
# the supervisor DOWN_SINCE (cleared by the engine at ready) and RESPAWNS.
(
    ENG_INCARNATION,
    ENG_DOWN_SINCE,
    ENG_RESPAWNS,
    ENG_REPLAYED,
    ENG_ROWS_LOST,
    ENG_ROWS_DISPATCHED,
    ENG_EXPIRED,
    ENG_DEGRADED,
) = range(8)


def _counter(name: str, value) -> list[str]:
    return [f"# TYPE {name} counter", f"{name} {value}"]


def latency_good_buckets(threshold_ms: float) -> int:
    """How many latency buckets count as good for the latency SLO: the
    smallest edge at or above the threshold is the effective one."""
    for i, edge in enumerate(LATENCY_BUCKETS):
        if edge >= threshold_ms:
            return i + 1
    return len(LATENCY_BUCKETS)


def robustness_lines(deadline_expired: int, degraded: int, trace_dropped: int = 0,
                     flight_dumps: int = 0) -> list[str]:
    """The JAX ``ServingMetrics.robustness_lines``: one block, both
    planes, always emitted (a zero baseline keeps the counters'
    monotonicity checkable)."""
    return [
        *_counter("mlops_tpu_deadline_expired_total", int(deadline_expired)),
        *_counter("mlops_tpu_degraded_dispatch_total", int(degraded)),
        *_counter("mlops_tpu_trace_dropped_total", int(trace_dropped)),
        *_counter("mlops_tpu_flightrec_dumps_total", int(flight_dumps)),
    ]


def observability_lines(ring) -> list[str]:
    """The ring's shape histograms, SLO block and ledger series, each only
    once armed (the JAX ring render's blocks, from the same rows)."""
    lines: list[str] = []
    R = ring.replicas
    armed = [r for r in range(R) if float(ring.shape_meta[r]) > 0]
    if armed:
        # Replicas warm identical entries: merged by key, the rate base is
        # the oldest armed clock, the evictions sum.
        entries = _shapes.merge_entries(
            [_shapes.read_table(ring.shape_keys[r], ring.shape_vals[r]) for r in armed])
        elapsed = time.monotonic() - min(float(ring.shape_meta[r]) for r in armed)
        evicted = int(sum(float(ring.shape_evicted[r]) for r in armed))
        lines += _shapes.render_entries_lines(entries, elapsed, evicted=evicted)
    if ring.slo_armed:
        # engine_down is computed here: a dead engine cannot raise it.
        engine_down = not ring.engine_ready and bool(
            (ring.eng_vals[:, ENG_DOWN_SINCE] > 0).any())
        view = read_slo_view(ring.slo_vals, ring.alert_vals, ring.tenant_names,
                             tuple(float(x) for x in ring.slo_meta[:4]))
        lines += render_slo_lines(view, engine_down=engine_down)
    led = [r for r in range(R) if float(ring.ledger_meta[r]) > 0]
    if led:
        lines += _ledger.render_entry_lines(_ledger.merge_entries(
            [_ledger.read_table(ring.ledger_keys[r], ring.ledger_vals[r]) for r in led]))
    return lines


def lifecycle_lines(snapshot: dict | None, tenant: str = DEFAULT_TENANT_LABEL) -> list[str]:
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


def autotune_lines(snapshot: dict | None) -> list[str]:
    """The autotuner's gauge block (``AutotuneController.metrics_snapshot``),
    plane-level (no tenant label); empty until a controller runs."""
    if not snapshot:
        return []
    lines = [
        "# TYPE mlops_tpu_grid_generation gauge",
        f"mlops_tpu_grid_generation {int(snapshot['grid_generation'])}",
        "# TYPE mlops_tpu_autotune_plans_total counter",
    ]
    plans = snapshot.get("plans", {})
    for outcome in AUTOTUNE_OUTCOMES:
        lines.append(
            f'mlops_tpu_autotune_plans_total{{outcome="{outcome}"}} '
            f"{int(plans.get(outcome, 0))}"
        )
    # The audit pair: what the cost model promised for the last searched
    # plan against what the post-apply ledger window measured.
    for key, name in (("predicted_gain_pct", "mlops_tpu_autotune_predicted_gain_pct"),
                      ("measured_gain_pct", "mlops_tpu_autotune_measured_gain_pct")):
        value = snapshot.get(key)
        if value is not None:
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(value):.3f}")
    return lines


def _autotune_fold(ring) -> dict | None:
    """The armed replicas' autotune rows folded into one snapshot, as the
    JAX ring render folds them; None while no replica runs a controller."""
    vals = ring.auto_vals
    armed = [r for r in range(ring.replicas) if float(vals[r, AUTO_HAS])]
    if not armed:
        return None
    lead = armed[0]  # the lowest armed replica: the one that searched
    return {
        "grid_generation": int(min(vals[r, AUTO_GRID_GEN] for r in armed)),
        "plans": {outcome: int(sum(ring.auto_plans[r, i] for r in armed))
                  for i, outcome in enumerate(AUTOTUNE_OUTCOMES)},
        "predicted_gain_pct": (float(vals[lead, AUTO_PRED_GAIN])
                               if vals[lead, AUTO_HAS_PRED] else None),
        "measured_gain_pct": (float(vals[lead, AUTO_MEAS_GAIN])
                              if vals[lead, AUTO_HAS_MEAS] else None),
    }


def _lifecycle_row(ring, t: int) -> dict:
    """Tenant ``t``'s lifecycle row rebuilt as a controller snapshot, so
    the one formatter renders it on both planes."""
    life = ring.life_vals[t]
    return {
        "generation": int(life[LIFE_GENERATION]),
        "drift_triggers": int(life[LIFE_TRIGGERS]),
        "shadow_auc_delta": (float(life[LIFE_AUC_DELTA])
                             if life[LIFE_HAS_DELTA] else None),
        "promotions": {outcome: int(ring.life_promos[t, i])
                       for i, outcome in enumerate(LIFE_OUTCOMES)},
        "reservoir_rows": int(life[LIFE_RESERVOIR]),
        "breaker_open": bool(life[LIFE_BREAKER_OPEN]),
        "breaker_trips": int(life[LIFE_BREAKER_TRIPS]),
    }


def render_ring_metrics(ring) -> str:
    """Prometheus text for the whole ring plane, from ``ring``'s shared
    memory alone. The per-tenant request, depth, shed, quota and monitor
    series, the per-replica block and the lifecycle blocks are the JAX
    ring render's lines for the same rows."""
    tenants = ring.tenant_names
    R, T = ring.replicas, len(tenants)
    statuses = (*RING_STATUSES, "other")
    lines = ["# TYPE mlops_tpu_requests_total counter"]
    for w in range(ring.workers):
        for t, tenant in enumerate(tenants):
            for r_i, route in enumerate(ROUTES):
                row = ring.req_counts[w, t, r_i]
                for s_i, status in enumerate(statuses):
                    if int(row[s_i]):
                        lines.append(
                            f'mlops_tpu_requests_total{{route="{route}",'
                            f'status="{status}",worker="{w}",'
                            f'tenant="{tenant}"}} {int(row[s_i])}'
                        )
    lines.append("# TYPE mlops_tpu_request_latency_ms histogram")
    for w in range(ring.workers):
        for t, tenant in enumerate(tenants):
            cumulative = 0
            for edge, count in zip(LATENCY_BUCKETS, ring.lat_counts[w, t]):
                cumulative += int(count)
                label = "+Inf" if edge == float("inf") else str(edge)
                lines.append(
                    f'mlops_tpu_request_latency_ms_bucket{{le="{label}",'
                    f'worker="{w}",tenant="{tenant}"}} {cumulative}'
                )
            lines.append(
                f'mlops_tpu_request_latency_ms_sum{{worker="{w}",'
                f'tenant="{tenant}"}} {float(ring.lat_sum_ms[w, t])}'
            )
            lines.append(
                f'mlops_tpu_request_latency_ms_count{{worker="{w}",'
                f'tenant="{tenant}"}} {int(ring.lat_n[w, t])}'
            )
    # Every worker's depth and shed series for every tenant, always: a
    # scrape proves each worker exists even before it served traffic.
    for name, cells in (("mlops_tpu_ring_depth", ring.inflight),
                        ("mlops_tpu_shed_total", ring.shed)):
        kind = "gauge" if name.endswith("depth") else "counter"
        lines.append(f"# TYPE {name} {kind}")
        for w in range(ring.workers):
            for c_i, cls in enumerate(RING_CLASSES):
                for t, tenant in enumerate(tenants):
                    lines.append(
                        f'{name}{{worker="{w}",class="{cls}",'
                        f'tenant="{tenant}"}} {int(cells[w, t, c_i])}'
                    )
    # Sheds of a tenant's own weighted max-min quota, apart from physical
    # slot exhaustion.
    lines.append("# TYPE mlops_tpu_tenant_quota_shed_total counter")
    for w in range(ring.workers):
        for t, tenant in enumerate(tenants):
            lines.append(
                f'mlops_tpu_tenant_quota_shed_total{{worker="{w}",'
                f'tenant="{tenant}"}} {int(ring.quota_shed[w, t])}'
            )
    # The monitor aggregate folds the replica axis: totals sum over the
    # replica rows; the drift mean is recomputed from the unrounded sums;
    # drift_last comes from the most recently fetched row.
    mon = ring.mon_vals
    lines.append("# TYPE mlops_tpu_rows_scored_total counter")
    for t, tenant in enumerate(tenants):
        lines.append(f'mlops_tpu_rows_scored_total{{tenant="{tenant}"}} '
                     f"{int(mon[:, t, MON_ROWS].sum())}")
    lines.append("# TYPE mlops_tpu_outliers_total counter")
    for t, tenant in enumerate(tenants):
        lines.append(f'mlops_tpu_outliers_total{{tenant="{tenant}"}} '
                     f"{int(mon[:, t, MON_OUTLIERS].sum())}")
    if mon[:, :, MON_HAS].any():
        lines.append("# TYPE mlops_tpu_feature_drift_score gauge")
        for t, tenant in enumerate(tenants):
            has = [r for r in range(R) if mon[r, t, MON_HAS]]
            if not has:
                continue
            last = max(has, key=lambda r: (float(mon[r, t, MON_FETCHED_AT]), -r))
            for feature, score in zip(SCHEMA.feature_names, ring.mon_drift_last[last, t]):
                lines.append(f'mlops_tpu_feature_drift_score{{feature="{feature}",'
                             f'tenant="{tenant}"}} {float(score)}')
        if mon[:, :, MON_FETCHES].sum():
            lines.append("# TYPE mlops_tpu_feature_drift_mean gauge")
            for t, tenant in enumerate(tenants):
                if not int(mon[:, t, MON_FETCHES].sum()):
                    continue
                if R == 1:
                    mean = ring.mon_drift_mean[0, t]
                else:
                    batches = float(mon[:, t, MON_BATCHES].sum())
                    mean = (ring.mon_drift_sum[:, t, :].sum(axis=0)
                            / max(batches, 1.0)).round(6)
                for feature, score in zip(SCHEMA.feature_names, mean):
                    lines.append(f'mlops_tpu_feature_drift_mean{{feature="{feature}",'
                                 f'tenant="{tenant}"}} {float(score)}')
    fetches = int(mon[:, :, MON_FETCHES].sum())
    if fetches:
        lines += _counter("mlops_tpu_monitor_fetches_total", fetches)
        lines.append("# TYPE mlops_tpu_monitor_batches_total counter")
        for t, tenant in enumerate(tenants):
            lines.append(f'mlops_tpu_monitor_batches_total{{tenant="{tenant}"}} '
                         f"{int(mon[:, t, MON_BATCHES].sum())}")
        # The oldest fetched row's age: one stuck (replica, tenant) row
        # never hides behind another's fresh fetch.
        fetched = [float(mon[r, t, MON_FETCHED_AT]) for r in range(R) for t in range(T)
                   if float(mon[r, t, MON_FETCHED_AT]) > 0]
        if fetched:
            lines += [
                "# TYPE mlops_tpu_monitor_fetch_age_seconds gauge",
                "mlops_tpu_monitor_fetch_age_seconds "
                f"{time.monotonic() - min(fetched):.3f}",
            ]
    eng = ring.eng_vals
    lines += robustness_lines(
        int(ring.expired.sum()) + int(eng[:, ENG_EXPIRED].sum()),
        int(eng[:, ENG_DEGRADED].sum()),
        int(ring.trace_dropped.sum()),
        int(ring.flight_dumps.sum()),
    )
    lines += _counter("mlops_tpu_engine_respawn_total", int(eng[:, ENG_RESPAWNS].sum()))
    lines += _counter("mlops_tpu_replayed_slots_total", int(eng[:, ENG_REPLAYED].sum()))
    lines += _counter("mlops_tpu_monitor_rows_lost_total", int(eng[:, ENG_ROWS_LOST].sum()))
    lines += [
        "# TYPE mlops_tpu_parked_requests gauge",
        f"mlops_tpu_parked_requests {int(ring.parked.sum())}",
    ]
    lines += _counter("mlops_tpu_brownout_shed_total", int(ring.brownout_shed.sum()))
    down = [float(v) for v in eng[:, ENG_DOWN_SINCE] if v > 0]
    lines += [
        "# TYPE mlops_tpu_engine_incarnation gauge",
        f"mlops_tpu_engine_incarnation {int(eng[:, ENG_INCARNATION].sum())}",
        # The monotonic time the supervisor saw the earliest replica still
        # down die; 0 while every replica is up.
        "# TYPE mlops_tpu_engine_down_since gauge",
        f"mlops_tpu_engine_down_since {min(down) if down else 0.0}",
        "# TYPE mlops_tpu_tier_requests_total counter",
    ]
    for i, tier in enumerate(TIERS):
        lines.append(
            f'mlops_tpu_tier_requests_total{{tier="{tier}"}} '
            f"{int(ring.tier_counts[:, i].sum())}"
        )
    lines += _counter("mlops_tpu_tier_demotions_total", int(ring.tier_demote.sum()))
    lines += _counter("mlops_tpu_brownout_demote_total",
                      int(ring.brownout_demote.sum()))
    # Every replica's series on every scrape: a replica that never
    # dispatched exports zeros, as "no series" reads as a dead replica.
    for name, kind, values in (
        ("mlops_tpu_replica_ready", "gauge",
         [1 if ring.rep_ready[r] else 0 for r in range(R)]),
        ("mlops_tpu_replica_ring_depth", "gauge",
         [int(ring.rep_inflight[:, r].sum()) for r in range(R)]),
        ("mlops_tpu_replica_incarnation", "gauge",
         [int(eng[r, ENG_INCARNATION]) for r in range(R)]),
        ("mlops_tpu_replica_respawn_total", "counter",
         [int(eng[r, ENG_RESPAWNS]) for r in range(R)]),
        ("mlops_tpu_replica_replayed_slots_total", "counter",
         [int(eng[r, ENG_REPLAYED]) for r in range(R)]),
        ("mlops_tpu_replica_rows_scored_total", "counter",
         [int(mon[r, :, MON_ROWS].sum()) for r in range(R)]),
    ):
        lines.append(f"# TYPE {name} {kind}")
        lines += [f'{name}{{replica="{r}"}} {v}' for r, v in enumerate(values)]
    lines.append("# TYPE mlops_tpu_dispatches_total counter")
    for entry, count in sorted(ring.dispatch_counts().items()):
        lines.append(f'mlops_tpu_dispatches_total{{entry="{entry}"}} {count}')
    lines += [
        "# TYPE mlops_tpu_kernel_launches_total counter",
        'mlops_tpu_kernel_launches_total{kernel="quant_fused"} '
        f"{int(ring.kernel_launches.sum())}",
    ]
    lines += observability_lines(ring)
    lines += autotune_lines(_autotune_fold(ring))
    for t, tenant in enumerate(tenants):
        if ring.life_vals[t, LIFE_HAS]:
            # The engine process's loop state per tenant.
            lines += lifecycle_lines(_lifecycle_row(ring, t), tenant)
    return "\n".join(lines) + "\n"
