"""Gated promotion: the JAX package's ``lifecycle/promote.py``.

- ``roc_auc_np``: ROC-AUC by the Mann-Whitney U statistic with average
  ranks for ties;
- ``expected_calibration_error``: ECE over equal-width probability bins;
- ``evaluate_gates``: the three gates over one shadow report — the
  candidate's holdout AUC may trail the incumbent's by at most
  ``max_auc_drop``, its ECE must stay under ``max_ece``, and its p99 on
  mirrored traffic within ``max_p99_ratio`` x the incumbent's (skipped
  without mirrored samples, as in the offline pass);
- ``quant_tier_gates``: the AUC and calibration gates applied to the
  quantized student on the held-out split. The decision is stamped into
  the bundle's ``quant`` block, and the engine serves the tier only when
  it passed;
- ``promote_engine`` / ``rollback_engine``: the hot swap and its one-call
  undo (``InferenceEngine.swap_bundle`` / ``rollback``).

The metric helpers are numpy only, so the gate math runs the same in the
serving process, the offline ``lifecycle`` command and the tests.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from mlops_tpu_torch.config import LifecycleConfig

if TYPE_CHECKING:
    from mlops_tpu_torch.lifecycle.shadow import ShadowEngine, ShadowReport


def roc_auc_np(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC via the Mann-Whitney U statistic with average ranks for
    ties (0.5 when a class is absent or there are no rows)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    n = scores.shape[0]
    if n == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    first = np.searchsorted(sorted_scores, scores, side="left")
    last = np.searchsorted(sorted_scores, scores, side="right")
    ranks = (first + last + 1.0) / 2.0
    n_pos = labels.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    u = float((ranks * labels).sum()) - n_pos * (n_pos + 1.0) / 2.0
    return float(u / (n_pos * n_neg))


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, bins: int = 10
) -> float:
    """ECE over equal-width probability bins: sum_b (n_b/N) *
    |mean confidence_b - empirical rate_b|."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels, np.float64)
    if probs.size == 0:
        return 0.0
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(probs, edges[1:-1]), 0, bins - 1)
    ece = 0.0
    for b in range(bins):
        sel = idx == b
        n_b = int(sel.sum())
        if not n_b:
            continue
        ece += (n_b / probs.size) * abs(
            float(probs[sel].mean()) - float(labels[sel].mean())
        )
    return float(ece)


@dataclasses.dataclass(frozen=True)
class GateDecision:
    passed: bool
    reasons: tuple[str, ...]  # every failed gate, named with its numbers

    def as_dict(self) -> dict:
        return {"passed": self.passed, "reasons": list(self.reasons)}


def evaluate_gates(
    report: "ShadowReport", config: LifecycleConfig
) -> GateDecision:
    """The three gates over one shadow report. Latency is skipped (passes)
    when neither side has samples — the offline CLI pass has no mirrored
    traffic and must still be able to grade AUC/ECE."""
    reasons: list[str] = []
    if report.auc_delta < -config.max_auc_drop:
        reasons.append(
            f"auc: candidate {report.auc_candidate:.4f} trails incumbent "
            f"{report.auc_incumbent:.4f} by {-report.auc_delta:.4f} > "
            f"epsilon {config.max_auc_drop:g}"
        )
    if report.ece_candidate > config.max_ece:
        reasons.append(
            f"calibration: candidate ECE {report.ece_candidate:.4f} > "
            f"bound {config.max_ece:g}"
        )
    if report.p99_incumbent_ms > 0 and (
        report.p99_candidate_ms
        > config.max_p99_ratio * report.p99_incumbent_ms
    ):
        reasons.append(
            f"latency: candidate p99 {report.p99_candidate_ms:.2f} ms > "
            f"{config.max_p99_ratio:g}x incumbent "
            f"{report.p99_incumbent_ms:.2f} ms"
        )
    return GateDecision(passed=not reasons, reasons=tuple(reasons))


def quant_tier_gates(
    fidelity: dict[str, float], config: LifecycleConfig
) -> GateDecision:
    """Grade the quantized student from its held-out fidelity record: its
    AUC may trail the teacher's by at most ``max_auc_drop``, and its
    calibrated ECE stay under ``max_ece``. A record without an AUC delta
    (no labelled split) fails: an ungraded tier must not serve."""
    reasons: list[str] = []
    delta = fidelity.get("roc_auc_delta")
    if delta is None:
        reasons.append(
            "auc: no labeled validation split — the quant tier cannot be "
            "graded and must not serve"
        )
    elif delta < -config.max_auc_drop:
        reasons.append(
            f"auc: quant student trails the teacher by {-delta:.4f} > "
            f"epsilon {config.max_auc_drop:g}"
        )
    ece = fidelity.get("ece")
    if ece is not None and ece > config.max_ece:
        reasons.append(
            f"calibration: quant ECE {ece:.4f} > bound {config.max_ece:g}"
        )
    return GateDecision(passed=not reasons, reasons=tuple(reasons))


def promote_engine(live, shadow: "ShadowEngine") -> int:
    """Install the shadowed candidate into the live engine (zero-downtime
    swap, ``InferenceEngine.swap_bundle``). Returns the new bundle
    generation."""
    return live.swap_bundle(shadow.engine)


def rollback_engine(live) -> int:
    """One-call rollback to the retained previous bundle."""
    return live.rollback()
