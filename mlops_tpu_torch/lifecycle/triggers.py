"""Trigger policies: when does the monitor evidence justify a retrain?

The JAX package's ``lifecycle/triggers.py``, unchanged in behaviour.
Evaluated against `InferenceEngine.monitor_snapshot()` aggregates (the
device-resident accumulator's cumulative totals — `monitor/state.py`).
The snapshot's counters are CUMULATIVE, so the policy differences
consecutive snapshots into per-window statistics: windowed mean drift
per feature ((drift_sum_t2 - drift_sum_t1) / (batches_t2 - batches_t1),
recovered from the exported means), windowed outlier rate, and windowed
row count. Firing requires

- enough evidence: the window carries >= ``min_window_rows`` scored rows,
- a breach: any feature's windowed mean drift >= ``drift_threshold``
  (drift scores are ``1 - p_val``) OR the windowed outlier rate >=
  ``outlier_threshold``,
- hysteresis: ``hysteresis_windows`` CONSECUTIVE breached windows — one
  noisy window can never retrain-storm; a clean window resets the streak,
- cooldown: after any fire (or a promotion/rejection outcome, which the
  controller reports via ``start_cooldown``), breaches neither fire nor
  accumulate hysteresis for ``cooldown_s`` — a drift spike inside the
  cooldown window does not re-trigger retrain.

Pure host arithmetic, no locks, no torch: the controller owns threading;
the clock is injected (``now``) so tests drive time deterministically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mlops_tpu_torch.config import LifecycleConfig


@dataclasses.dataclass(frozen=True)
class TriggerDecision:
    """One window's verdict (returned by ``TriggerPolicy.observe``)."""

    fired: bool
    reason: str  # "" when not fired; else the named breach
    window_rows: float = 0.0
    drift_max: float = 0.0  # max windowed per-feature mean drift score
    drift_feature: str = ""  # the feature that carried drift_max
    outlier_rate: float = 0.0
    streak: int = 0  # consecutive breached windows so far
    in_cooldown: bool = False


class TriggerPolicy:
    """Threshold + hysteresis + cooldown over consecutive snapshots."""

    def __init__(self, config: LifecycleConfig):
        self.config = config.validate()
        self._prev: dict | None = None  # last snapshot's cumulative view
        self._streak = 0
        self._cooldown_until = float("-inf")

    # ------------------------------------------------------------ control
    def start_cooldown(self, now: float) -> None:
        """Arm the dead time (called on fire and on every candidate
        outcome — promoted, rejected, or rolled back — so the loop
        settles before re-evaluating)."""
        self._cooldown_until = now + self.config.cooldown_s
        self._streak = 0

    def in_cooldown(self, now: float) -> bool:
        return now < self._cooldown_until

    def consume(self, snapshot: dict) -> None:
        """Fold a snapshot into the differencing baseline WITHOUT any
        evaluation side effects — no firing, no hysteresis accumulation,
        no cooldown arming. The lifecycle circuit breaker consumes
        windows this way while open: the window sequence stays
        continuous (the first post-close observation differences against
        fresh state, not the pre-open past), but an open breaker can
        never mutate the trigger machinery's state."""
        if snapshot:
            self._prev = _cumulative_view(snapshot)

    # ------------------------------------------------------------ observe
    def observe(self, snapshot: dict, now: float) -> TriggerDecision:
        """Fold one cumulative snapshot; decide whether to fire."""
        if not snapshot:
            return TriggerDecision(fired=False, reason="")
        cum = _cumulative_view(snapshot)
        prev, self._prev = self._prev, cum
        if prev is None:
            # First observation: no window to difference yet. The
            # cumulative totals become the baseline — everything before
            # the policy attached is pre-history, not evidence.
            return TriggerDecision(fired=False, reason="")
        rows = cum["rows"] - prev["rows"]
        batches = cum["batches"] - prev["batches"]
        outliers = cum["outliers"] - prev["outliers"]
        if batches <= 0 or rows <= 0:
            return TriggerDecision(fired=False, reason="", window_rows=rows)
        drift = (cum["drift_sum"] - prev["drift_sum"]) / batches
        feature_idx = int(np.argmax(drift))
        drift_max = float(drift[feature_idx])
        outlier_rate = float(outliers / rows)
        decision = dict(
            window_rows=float(rows),
            drift_max=drift_max,
            drift_feature=cum["features"][feature_idx],
            outlier_rate=outlier_rate,
            in_cooldown=self.in_cooldown(now),
        )
        if decision["in_cooldown"]:
            # Cooldown: breaches neither fire nor accumulate hysteresis.
            return TriggerDecision(fired=False, reason="", **decision)
        if rows < self.config.min_window_rows:
            # NO EVIDENCE, not a clean bill: a thin window (traffic lull,
            # bursty arrival straddling ticks) leaves the streak
            # untouched — resetting here would let alternating thin/full
            # windows mask hours of sustained real drift forever.
            return TriggerDecision(
                fired=False, reason="", streak=self._streak, **decision
            )
        breach = ""
        if drift_max >= self.config.drift_threshold:
            breach = (
                f"drift {drift_max:.3f} >= "
                f"{self.config.drift_threshold:g} on "
                f"{decision['drift_feature']}"
            )
        elif outlier_rate >= self.config.outlier_threshold:
            breach = (
                f"outlier rate {outlier_rate:.3f} >= "
                f"{self.config.outlier_threshold:g}"
            )
        if not breach:
            self._streak = 0
            return TriggerDecision(fired=False, reason="", **decision)
        self._streak += 1
        if self._streak < self.config.hysteresis_windows:
            return TriggerDecision(
                fired=False, reason="", streak=self._streak, **decision
            )
        self.start_cooldown(now)
        return TriggerDecision(
            fired=True,
            reason=breach,
            streak=self.config.hysteresis_windows,
            **decision,
        )


def _cumulative_view(snapshot: dict) -> dict:
    """Snapshot dict -> the cumulative quantities the window differencing
    needs. Prefers the UNROUNDED ``drift_sum`` the engine exports
    (serve/engine.py monitor_snapshot): reconstructing the sum from the
    6-decimal-rounded display means would carry up to ``5e-7 * batches``
    of error — unbounded over a long-lived server, enough to fire (or
    mask) triggers spuriously after hours of uptime. The mean*batches
    fallback exists only for foreign snapshot producers (test stubs)."""
    features = list(snapshot["drift_mean"])
    batches = float(snapshot["batches"])
    if "drift_sum" in snapshot:
        drift_sum = np.asarray(snapshot["drift_sum"], np.float64)
    else:
        mean = np.asarray(
            [snapshot["drift_mean"][name] for name in features], np.float64
        )
        drift_sum = mean * max(batches, 0.0)
    return {
        "rows": float(snapshot["rows"]),
        "outliers": float(snapshot["outliers"]),
        "batches": batches,
        "drift_sum": drift_sum,
        "features": features,
    }
