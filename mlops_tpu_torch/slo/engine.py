"""SLO / error-budget engine: burn rates, alerts, and the health verdict.

The accounting model is the SRE-workbook multiwindow multi-burn-rate
alerting scheme over two SLO dimensions per tenant:

- ``availability`` — the fraction of ``/predict`` requests answered
  without a server-side failure (5xx: the 500 contract, shed 503s, and
  deadline 504s all spend budget — a shed request is not goodput, which
  is exactly the fleet-goodput framing of PAPERS.md arXiv 2502.06982);
- ``latency`` — the fraction of requests answered inside the configured
  threshold, measured against the existing latency histogram (the
  effective threshold is the smallest bucket edge >= the configured one;
  the gauges say which).

A burn rate is ``bad_fraction / (1 - target)`` over a trailing window:
1.0 means the error budget spends exactly at the rate that exhausts it
at the window's end; 14.4 (the classic page threshold) exhausts a
30-day budget in ~2 days. Each alert requires BOTH its windows over the
threshold — the long window filters blips, the short window ends the
alert quickly once the burn stops.

Everything here is torch-free and plane-agnostic: the single-process
server ticks an `SLOEngine` against `ServingMetrics.slo_counts`; the
multi-worker plane's LEAD engine replica ticks one against the shm
ring's fleet counters and mirrors the result into shm rows
(`write_slo_rows`) so any SO_REUSEPORT front end renders fleet verdicts
(`read_slo_view` + the ONE formatter `render_slo_lines` — the
`ServingMetrics.robustness_lines` discipline: identical series names on
both planes). The ``engine_down`` alert is the one exception: it is
computed at RENDER time by whoever answers the scrape, because a dead
engine cannot report its own death.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Callable

# Lock layout: one leaf lock guarding the sample deques and
# the computed view. `tick` calls its counter source OUTSIDE the lock
# (sources take their own leaf locks — ServingMetrics._lock); inside is
# pure host arithmetic, never I/O, never a device call.

SLO_NAMES = ("availability", "latency")

# Alerts the ENGINE evaluates per tenant (their flags live in the shm
# mirror). ``engine_down`` is deliberately absent: the renderer computes
# it from supervisor state. Order is the shm column order.
ENGINE_ALERTS = (
    "availability_fast_burn",
    "availability_slow_burn",
    "latency_fast_burn",
    "latency_slow_burn",
    "lifecycle_breaker",
)
ALERT_SEVERITY = {
    "availability_fast_burn": "page",
    "availability_slow_burn": "ticket",
    "latency_fast_burn": "page",
    "latency_slow_burn": "ticket",
    "lifecycle_breaker": "ticket",
    "engine_down": "page",
}

# Per-tenant shm row layout (serve/ipc.py ``slo_vals``): a HAS flag then
# 7 fields per SLO dimension, in SLO_NAMES order.
SLO_HAS = 0
_PER_SLO = 7  # good, total, budget_pct, burn x 4 windows
SLO_FIELDS = 1 + _PER_SLO * len(SLO_NAMES)
N_ENGINE_ALERTS = len(ENGINE_ALERTS)

# Per-tenant sample cap: at the default 1 s tick the 3-day slow window
# would otherwise retain ~259k samples per tenant and the per-tick
# reference scans would grow with uptime. Past the cap the OLDEST half
# thins to every-other sample (repeatedly, so resolution decays
# geometrically with age): the recent region stays tick-fine for the
# fast windows while a 3-day window's reference lands within ~minutes
# of its ideal position — a fraction-of-a-percent burn error on a
# 3-day number, for O(1) memory and O(log n) lookups (bisect; the list
# is time-sorted).
_MAX_SAMPLES = 4096


def window_label(seconds: float) -> str:
    """Human window label for the ``window=`` series dimension: 300 ->
    "5m", 3600 -> "1h", 259200 -> "3d"; anything non-round stays "Ns"
    (test-scale sub-minute windows render honestly)."""
    s = int(seconds)
    if s >= 86400 and s % 86400 == 0:
        return f"{s // 86400}d"
    if s >= 3600 and s % 3600 == 0:
        return f"{s // 3600}h"
    if s >= 60 and s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


def _zero_slo_block(windows: tuple[float, ...]) -> dict[str, Any]:
    return {
        "good": 0,
        "total": 0,
        "budget_pct": 100.0,
        "burn": {window_label(w): 0.0 for w in windows},
    }


def zero_view(
    tenants: tuple[str, ...], windows: tuple[float, ...]
) -> dict[str, Any]:
    """The always-emit baseline: every series exists (at zero / full
    budget) from the first scrape — "no series" must never be
    confusable with "no problem" (the always-emit contract)."""
    return {
        tenant: {
            "slos": {slo: _zero_slo_block(windows) for slo in SLO_NAMES},
            "alerts": {alert: False for alert in ENGINE_ALERTS},
        }
        for tenant in tenants
    }


class SLOEngine:
    """Windowed SLO evaluation over cumulative good/total counters.

    ``source()`` returns ``{tenant_label: (avail_good, avail_total,
    lat_good, lat_total)}`` — CUMULATIVE counts since process start (the
    engine differences them itself). ``breaker_source()`` (optional)
    returns ``{tenant_label: bool}`` — the lifecycle circuit breaker's
    open flag, surfaced as the ``lifecycle_breaker`` alert so a broken
    retrain path pages through the same channel as a burn.
    ``on_alert(alert, tenant, severity)`` fires on each INACTIVE ->
    ACTIVE transition (the flight recorder's dump trigger).

    ``prior_counts`` (``{tenant: (avail_good, avail_total, lat_good,
    lat_total)}``) seeds the exported totals with a PREDECESSOR's
    published values — the respawn-base discipline: a
    respawned engine replica's fresh evaluator re-baselines against
    the (surviving) shm request counters, and without the seed its
    ``slo_*_total`` series would restart near zero, which Prometheus
    reads as a counter reset (and the chaos smoke flags as a monotone
    regression). Seeded, the first tick re-publishes exactly the dead
    incarnation's totals and growth continues from there.
    """

    def __init__(
        self,
        config: Any,  # config.SLOConfig (duck-typed: torch-free module)
        tenants: tuple[str, ...],
        source: Callable[[], dict[str, tuple[int, int, int, int]]],
        breaker_source: Callable[[], dict[str, bool]] | None = None,
        on_alert: Callable[[str, str, str], None] | None = None,
        prior_counts: dict[str, tuple[int, int, int, int]] | None = None,
    ) -> None:
        self.config = config
        self.tenants = tuple(tenants) or ("default",)
        self._source = source
        self._breaker_source = breaker_source
        self._on_alert = on_alert
        self.windows: tuple[float, ...] = (
            float(config.fast_short_s),
            float(config.fast_long_s),
            float(config.slow_short_s),
            float(config.slow_long_s),
        )
        self._targets = {
            "availability": float(config.availability_target),
            "latency": float(config.latency_target),
        }
        self._lock = threading.Lock()
        # tenant -> list of (t, avail_good, avail_total, lat_good,
        # lat_total) samples, pruned to the slowest window. The
        # CONSTRUCTION-TIME sample is kept separately as the budget
        # BASELINE: budgets measure what happened since sloscope armed,
        # so counters predating it never bill the budget — and window
        # pruning can never silently turn the budget into a rolling one.
        self._samples: dict[str, list[tuple[float, ...]]] = {}
        self._baseline: dict[str, tuple[float, ...]] = {}
        self._prior = dict(prior_counts or {})
        self._active: dict[tuple[str, str], bool] = {
            (alert, tenant): False
            for alert in ENGINE_ALERTS
            for tenant in self.tenants
        }
        self._view = zero_view(self.tenants, self.windows)
        self.ticks = 0
        self.tick()

    # -------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> None:
        """One evaluation: sample the cumulative counters, recompute every
        window's burn rate, update alert states (firing ``on_alert`` on
        rising edges). Cheap host arithmetic — safe at any cadence; the
        acceptance contract is "alerts flip within two ticks of the
        counters crossing the threshold"."""
        now = time.monotonic() if now is None else float(now)
        counts = self._source()  # outside the lock: sources self-lock
        breakers = (
            self._breaker_source() if self._breaker_source is not None else {}
        )
        fired: list[tuple[str, str]] = []
        with self._lock:
            horizon = now - max(self.windows) - 2.0 * float(
                self.config.tick_s
            )
            view: dict[str, Any] = {}
            for tenant in self.tenants:
                ag, at, lg, lt = (
                    int(x) for x in counts.get(tenant, (0, 0, 0, 0))
                )
                samples = self._samples.setdefault(tenant, [])
                samples.append((now, ag, at, lg, lt))
                if tenant not in self._baseline:
                    s0 = samples[0]
                    prior = self._prior.get(tenant)
                    if prior:
                        # Respawn-base seed: shift the baseline back by
                        # the predecessor's published totals so the
                        # exported counters continue instead of reset.
                        self._baseline[tenant] = (
                            s0[0],
                            s0[1] - int(prior[0]),
                            s0[2] - int(prior[1]),
                            s0[3] - int(prior[2]),
                            s0[4] - int(prior[3]),
                        )
                    else:
                        self._baseline[tenant] = s0
                while len(samples) > 2 and samples[1][0] <= horizon:
                    # Keep one sample older than the slowest window so
                    # every window has a reference to difference against.
                    samples.pop(0)
                if len(samples) > _MAX_SAMPLES:
                    # Bounded retention: thin the oldest half to
                    # every-other sample (see _MAX_SAMPLES).
                    half = len(samples) // 2
                    samples[:half] = samples[:half:2]
                blocks: dict[str, Any] = {}
                for s_i, slo in enumerate(SLO_NAMES):
                    gi, ti = 1 + 2 * s_i, 2 + 2 * s_i
                    base = self._baseline[tenant]
                    good = samples[-1][gi] - base[gi]
                    total = samples[-1][ti] - base[ti]
                    budget = 1.0 - self._targets[slo]
                    bad_frac = (
                        (total - good) / total if total > 0 else 0.0
                    )
                    budget_pct = (
                        100.0 * (1.0 - bad_frac / budget)
                        if budget > 0
                        else 100.0
                    )
                    burns: dict[str, float] = {}
                    for w in self.windows:
                        # Last sample at or before the window start,
                        # falling back to the oldest retained (a window
                        # older than the history uses what exists).
                        idx = bisect.bisect_right(
                            samples, now - w, key=lambda s: s[0]
                        )
                        ref = samples[idx - 1] if idx > 0 else samples[0]
                        d_total = samples[-1][ti] - ref[ti]
                        d_good = samples[-1][gi] - ref[gi]
                        frac = (
                            (d_total - d_good) / d_total
                            if d_total > 0
                            else 0.0
                        )
                        burns[window_label(w)] = round(
                            frac / budget if budget > 0 else 0.0, 4
                        )
                    blocks[slo] = {
                        "good": good,
                        "total": total,
                        "budget_pct": round(budget_pct, 3),
                        "burn": burns,
                    }
                alerts: dict[str, bool] = {}
                for slo in SLO_NAMES:
                    burns = blocks[slo]["burn"]
                    fast = float(self.config.fast_burn_threshold)
                    slow = float(self.config.slow_burn_threshold)
                    fs, fl = self.windows[0], self.windows[1]
                    ss, sl = self.windows[2], self.windows[3]
                    alerts[f"{slo}_fast_burn"] = (
                        burns[window_label(fs)] >= fast
                        and burns[window_label(fl)] >= fast
                    )
                    alerts[f"{slo}_slow_burn"] = (
                        burns[window_label(ss)] >= slow
                        and burns[window_label(sl)] >= slow
                    )
                alerts["lifecycle_breaker"] = bool(breakers.get(tenant))
                for alert, active in alerts.items():
                    key = (alert, tenant)
                    if active and not self._active[key]:
                        fired.append(key)
                    self._active[key] = active
                view[tenant] = {"slos": blocks, "alerts": alerts}
            self._view = view
            self.ticks += 1
        if self._on_alert is not None:
            for alert, tenant in fired:
                # Outside the lock: the hook may dump a flight recording.
                self._on_alert(alert, tenant, ALERT_SEVERITY[alert])

    # ------------------------------------------------------------- reads
    def view(self) -> dict[str, Any]:
        with self._lock:
            return self._view

    def any_alert_active(self) -> bool:
        with self._lock:
            return any(self._active.values())

    def render_lines(self, engine_down: bool = False) -> list[str]:
        return render_slo_lines(self.view(), engine_down=engine_down)

    # -------------------------------------------------------- shm mirror
    def write_rows(self, slo_vals, alert_vals) -> None:
        """Mirror the computed view into the ring's per-tenant rows
        (engine-process single writer; per-field f64 stores are
        individually atomic — the `write_monitor` tearing contract)."""
        view = self.view()
        for t, tenant in enumerate(self.tenants):
            block = view[tenant]
            row = slo_vals[t]
            for s_i, slo in enumerate(SLO_NAMES):
                b = block["slos"][slo]
                o = 1 + s_i * _PER_SLO
                row[o] = float(b["good"])
                row[o + 1] = float(b["total"])
                row[o + 2] = float(b["budget_pct"])
                for w_i, w in enumerate(self.windows):
                    row[o + 3 + w_i] = float(b["burn"][window_label(w)])
            for a_i, alert in enumerate(ENGINE_ALERTS):
                alert_vals[t, a_i] = 1.0 if block["alerts"][alert] else 0.0
            row[SLO_HAS] = 1.0


def read_slo_view(
    slo_vals,
    alert_vals,
    tenants: tuple[str, ...],
    windows: tuple[float, ...],
) -> dict[str, Any]:
    """Rebuild the view dict from the shm rows (any front end renders the
    fleet verdict the lead replica last published; rows never written —
    e.g. the engine died before its first tick — render the zero
    baseline, which is exactly the last-known-values contract)."""
    view = zero_view(tenants, windows)
    for t, tenant in enumerate(tenants):
        row = slo_vals[t]
        if not float(row[SLO_HAS]):
            continue
        block = view[tenant]
        for s_i, slo in enumerate(SLO_NAMES):
            o = 1 + s_i * _PER_SLO
            block["slos"][slo] = {
                "good": int(row[o]),
                "total": int(row[o + 1]),
                "budget_pct": round(float(row[o + 2]), 3),
                "burn": {
                    window_label(w): round(float(row[o + 3 + w_i]), 4)
                    for w_i, w in enumerate(windows)
                },
            }
        block["alerts"] = {
            alert: bool(alert_vals[t, a_i])
            for a_i, alert in enumerate(ENGINE_ALERTS)
        }
    return view


def render_slo_lines(
    view: dict[str, Any], engine_down: bool = False
) -> list[str]:
    """THE SLO exposition block — ONE definition shared by the
    single-process render and the ring render so both planes export
    identical series names. Every series is ALWAYS emitted for every
    tenant and every alert (zero baseline; an absent series would be
    indistinguishable from a healthy one)."""
    lines = ["# TYPE mlops_tpu_slo_good_total counter"]
    tenants = sorted(view)
    for tenant in tenants:
        for slo in SLO_NAMES:
            lines.append(
                f'mlops_tpu_slo_good_total{{slo="{slo}",tenant="{tenant}"}} '
                f"{int(view[tenant]['slos'][slo]['good'])}"
            )
    lines.append("# TYPE mlops_tpu_slo_total counter")
    for tenant in tenants:
        for slo in SLO_NAMES:
            lines.append(
                f'mlops_tpu_slo_total{{slo="{slo}",tenant="{tenant}"}} '
                f"{int(view[tenant]['slos'][slo]['total'])}"
            )
    lines.append("# TYPE mlops_tpu_error_budget_remaining_pct gauge")
    for tenant in tenants:
        for slo in SLO_NAMES:
            lines.append(
                "mlops_tpu_error_budget_remaining_pct"
                f'{{slo="{slo}",tenant="{tenant}"}} '
                f"{view[tenant]['slos'][slo]['budget_pct']}"
            )
    lines.append("# TYPE mlops_tpu_slo_burn_rate gauge")
    for tenant in tenants:
        for slo in SLO_NAMES:
            for label, burn in view[tenant]["slos"][slo]["burn"].items():
                lines.append(
                    f'mlops_tpu_slo_burn_rate{{slo="{slo}",'
                    f'tenant="{tenant}",window="{label}"}} {burn}'
                )
    lines.append("# TYPE mlops_tpu_alert_active gauge")
    for tenant in tenants:
        for alert in ENGINE_ALERTS:
            active = view[tenant]["alerts"].get(alert, False)
            lines.append(
                f'mlops_tpu_alert_active{{alert="{alert}",'
                f'severity="{ALERT_SEVERITY[alert]}",tenant="{tenant}"}} '
                f"{1 if active else 0}"
            )
        # engine_down is renderer-computed (a dead engine cannot report
        # its own death): the same value for every tenant — the outage
        # is plane-wide.
        lines.append(
            f'mlops_tpu_alert_active{{alert="engine_down",'
            f'severity="{ALERT_SEVERITY["engine_down"]}",'
            f'tenant="{tenant}"}} {1 if engine_down else 0}'
        )
    return lines


def health_verdict(
    view: dict[str, Any] | None,
    ready: bool,
    engine_down: bool = False,
) -> tuple[int, dict[str, Any], str]:
    """THE ``/healthz`` verdict wire shape, shared by both planes:

    - ``down`` (503) — the engine is dead (full outage) or the plane
      never became ready: probes and gateways should route away;
    - ``degraded`` (200) — serving, but at least one alert is active
      (the body names them): humans should look;
    - ``ok`` (200) — serving inside its SLOs.

    200-with-degraded rather than 503 is deliberate: a burn alert means
    the error budget is SPENDING, not that this instance should be
    pulled — pulling it would turn a burn into an outage."""
    alerts: list[dict[str, str]] = []
    if view:
        for tenant in sorted(view):
            for alert, active in view[tenant]["alerts"].items():
                if active:
                    alerts.append(
                        {
                            "alert": alert,
                            "tenant": tenant,
                            "severity": ALERT_SEVERITY.get(alert, "ticket"),
                        }
                    )
    if engine_down:
        alerts.insert(
            0,
            {
                "alert": "engine_down",
                "tenant": "*",
                "severity": ALERT_SEVERITY["engine_down"],
            },
        )
    if engine_down or not ready:
        verdict, status = "down", 503
    elif alerts:
        verdict, status = "degraded", 200
    else:
        verdict, status = "ok", 200
    return (
        status,
        {"verdict": verdict, "ready": bool(ready), "alerts": alerts},
        "application/json",
    )
