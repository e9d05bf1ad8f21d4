"""The lifecycle loop's host-side pieces against the JAX package's, on the
CPU: the trigger policy (hysteresis, cooldown, the thin window, the
outlier path, ``consume``, the unrounded ``drift_sum`` view), the
promotion gates and their metric helpers, the sample reservoir (the same
seed and batches give the same rows; the npz crosses between the
packages), the streaming preprocessor fit, and the ``/metrics`` lifecycle
block byte for byte.

Decisions and records must be equal (the arithmetic is the same numpy
in both packages); the streaming fit's stats are compared bitwise.
"""

import dataclasses

import numpy as np
import pytest

from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.data.stream import fit_streaming as jax_fit_streaming
from mlops_tpu.lifecycle import SampleReservoir as JaxReservoir
from mlops_tpu.lifecycle import TriggerPolicy as JaxPolicy
from mlops_tpu.lifecycle import evaluate_gates as jax_evaluate_gates
from mlops_tpu.lifecycle.shadow import ShadowReport as JaxReport
from mlops_tpu.serve.metrics import ServingMetrics
from mlops_tpu_torch.config import Config
from mlops_tpu_torch.data.stream import fit_streaming
from mlops_tpu_torch.lifecycle.promote import (
    evaluate_gates,
    expected_calibration_error,
    roc_auc_np,
)
from mlops_tpu_torch.lifecycle.retrain import SampleReservoir
from mlops_tpu_torch.lifecycle.shadow import ShadowReport
from mlops_tpu_torch.lifecycle.triggers import TriggerPolicy
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve import metrics as port_metrics
from mlops_tpu_torch.serve.server import Metrics
from torch_lifecycle import budget, write_drifted_window  # noqa: F401


def _snap(rows, outliers, batches, drift, drift_sum=None):
    feats = {name: drift for name in SCHEMA.feature_names}
    snap = {
        "rows": rows, "outliers": outliers, "batches": batches,
        "drift_last": dict(feats), "drift_mean": dict(feats),
    }
    if drift_sum is not None:
        snap["drift_sum"] = [drift_sum] * len(SCHEMA.feature_names)
    return snap


# (knobs, [(snapshot, now), ...]) — the JAX suite's sequences and more.
SCENARIOS = {
    "hysteresis": (
        dict(min_window_rows=8, hysteresis_windows=2, drift_threshold=0.8,
             cooldown_s=100.0),
        [(_snap(10, 0, 1, 0.1), 0.0), (_snap(30, 0, 3, 0.95), 1.0),
         (_snap(60, 1, 6, 0.55), 2.0), (_snap(90, 1, 9, 0.95), 3.0),
         (_snap(120, 1, 12, 0.95), 4.0), (_snap(150, 1, 15, 0.95), 50.0)],
    ),
    "cooldown": (
        dict(min_window_rows=8, hysteresis_windows=1, drift_threshold=0.8,
             cooldown_s=100.0),
        [(_snap(10, 0, 1, 0.1), 0.0), (_snap(30, 0, 3, 0.95), 1.0),
         (_snap(60, 0, 6, 0.99), 50.0), (_snap(90, 0, 9, 0.99), 101.0)],
    ),
    "thin_window": (
        dict(min_window_rows=100, hysteresis_windows=2, drift_threshold=0.8,
             cooldown_s=0.0),
        [(_snap(10, 0, 1, 0.1), 0.0), (_snap(210, 0, 3, 0.95), 1.0),
         (_snap(220, 0, 4, 0.95), 2.0), (_snap(430, 0, 7, 0.95), 3.0)],
    ),
    "min_rows": (
        dict(min_window_rows=1000, hysteresis_windows=1, cooldown_s=0.0),
        [(_snap(10, 0, 1, 0.1), 0.0), (_snap(40, 0, 4, 0.99), 1.0)],
    ),
    "outlier": (
        dict(min_window_rows=8, hysteresis_windows=1, outlier_threshold=0.5,
             cooldown_s=0.0),
        [(_snap(10, 0, 1, 0.1), 0.0), (_snap(30, 15, 3, 0.1), 1.0),
         (_snap(30, 15, 3, 0.1), 2.0), (_snap(60, 15, 6, 0.1), 3.0)],
    ),
    "drift_sum": (
        dict(min_window_rows=8, hysteresis_windows=1, drift_threshold=0.9,
             cooldown_s=0.0),
        [(_snap(10, 0, 1, 0.1, drift_sum=0.1), 0.0),
         (_snap(30, 0, 3, 0.5, drift_sum=1.92), 1.0),
         (_snap(60, 0, 6, 0.6, drift_sum=3.5), 2.0),
         ({}, 3.0)],
    ),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trigger_decisions_match_the_jax_policy(name):
    knobs, sequence = SCENARIOS[name]
    cfg, jcfg = Config().lifecycle, JaxConfig().lifecycle
    for key, value in knobs.items():
        setattr(cfg, key, value)
        setattr(jcfg, key, value)
    port, jax_policy = TriggerPolicy(cfg), JaxPolicy(jcfg)
    fired = 0
    for snapshot, now in sequence:
        got = port.observe(snapshot, now)
        want = jax_policy.observe(snapshot, now)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, now)
        fired += got.fired
        assert port.in_cooldown(now) == jax_policy.in_cooldown(now)
    assert fired >= (name != "min_rows")


def test_consume_matches_the_jax_policy():
    """``consume`` advances the baseline only: no firing, no streak, no
    cooldown; the next observed window differences against it."""
    cfg, jcfg = Config().lifecycle, JaxConfig().lifecycle
    for c in (cfg, jcfg):
        c.hysteresis_windows, c.min_window_rows, c.cooldown_s = 1, 1, 300.0
    policies = (TriggerPolicy(cfg), JaxPolicy(jcfg))

    def snap(rows, drift):
        return {"rows": rows, "outliers": 0.0, "batches": rows,
                "drift_mean": {"f": drift}, "drift_sum": [drift * rows]}

    decisions = []
    for policy in policies:
        policy.consume(snap(100, 0.0))
        policy.consume(snap(200, 0.95 * 2))
        assert policy._streak == 0 and not policy.in_cooldown(0.0)
        decisions.append(policy.observe(snap(300, 0.95 * 3 + 0.98), now=1.0))
    assert decisions[0].fired
    assert dataclasses.asdict(decisions[0]) == dataclasses.asdict(decisions[1])


# ------------------------------------------------------------------- gates
BASE_REPORT = dict(
    auc_candidate=0.8, auc_incumbent=0.8, auc_delta=0.0,
    ece_candidate=0.02, ece_incumbent=0.02,
    p99_candidate_ms=1.0, p99_incumbent_ms=1.0,
    p50_candidate_ms=0.5, p50_incumbent_ms=0.5,
    mirrors=10, mirror_drops=0, mean_abs_pred_delta=0.0,
    holdout_rows=100, warm_mode="captured", warm_s=0.0,
)
REPORTS = {
    "pass": {},
    "auc": dict(auc_delta=-0.5, auc_candidate=0.3),
    "auc_edge": dict(auc_delta=-0.01, auc_candidate=0.79),
    "p99": dict(p99_candidate_ms=100.0),
    "p99_no_samples": dict(p99_candidate_ms=5.0, p99_incumbent_ms=0.0),
    "ece": dict(ece_candidate=0.9),
    "all": dict(auc_delta=-0.2, ece_candidate=0.5, p99_candidate_ms=3.0),
}


@pytest.mark.parametrize("name", sorted(REPORTS))
@pytest.mark.parametrize("max_ece", [0.1, 0.6])
def test_gates_match_the_jax_gates(name, max_ece):
    fields = dict(BASE_REPORT, **REPORTS[name])
    cfg, jcfg = Config().lifecycle, JaxConfig().lifecycle
    cfg.max_ece = jcfg.max_ece = max_ece
    got = evaluate_gates(ShadowReport(**fields), cfg)
    want = jax_evaluate_gates(JaxReport(**fields), jcfg)
    assert got.as_dict() == want.as_dict()
    assert got.passed == (name in ("pass", "auc_edge", "p99_no_samples")
                          or (name == "ece" and max_ece > 0.9))


def test_gate_metric_helpers_match_the_jax_ones():
    from mlops_tpu.lifecycle import expected_calibration_error as jax_ece
    from mlops_tpu.lifecycle import roc_auc_np as jax_auc

    rng = np.random.default_rng(4)
    labels = (rng.random(500) < 0.3).astype(np.float64)
    scores = np.clip(labels * 0.3 + rng.random(500) * 0.7, 0, 1).round(2)  # ties
    assert roc_auc_np(scores, labels) == jax_auc(scores, labels)
    assert expected_calibration_error(scores, labels) == jax_ece(scores, labels)
    assert roc_auc_np(np.full(6, 0.5), labels[:6]) == 0.5
    assert roc_auc_np(scores[:0], labels[:0]) == 0.5


# --------------------------------------------------------------- reservoir
def _batches(seed):
    rng = np.random.default_rng(seed)
    for n in rng.integers(1, 40, size=20):
        yield (rng.integers(0, 3, (n, SCHEMA.num_categorical)).astype(np.int32),
               rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32))


def test_reservoir_holds_the_jax_reservoirs_rows_bitwise(tmp_path):
    port = SampleReservoir(64, tmp_path / "port", seed=5)
    jax_res = JaxReservoir(64, tmp_path / "jax", seed=5)
    for cat, num in _batches(0):
        port.add_batch(cat, num)
        jax_res.add_batch(cat, num)
    assert (port.rows, port.rows_seen) == (jax_res.rows, jax_res.rows_seen) == (64, port.rows_seen)
    for got, want in zip(port.window(), jax_res.window()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_reservoir_npz_crosses_between_the_packages(tmp_path):
    port = SampleReservoir(32, tmp_path / "a", seed=1)
    for cat, num in _batches(1):
        port.add_batch(cat, num)
    port.save()
    jax_res = JaxReservoir(32, tmp_path / "a", seed=1)
    assert jax_res.load()
    assert (jax_res.rows, jax_res.rows_seen) == (port.rows, port.rows_seen)
    for got, want in zip(jax_res.window(), port.window()):
        np.testing.assert_array_equal(got, want)
    jax_res.add_batch(*next(_batches(2)))
    jax_res.save()
    back = SampleReservoir(32, tmp_path / "a", seed=1)
    assert back.load() and back.rows_seen == jax_res.rows_seen
    for got, want in zip(back.window(), jax_res.window()):
        np.testing.assert_array_equal(got, want)
    assert not list((tmp_path / "a").glob("*.tmp"))


# ----------------------------------------------------------- streaming fit
@pytest.mark.parametrize("chunk_rows,depth", [(65_536, 1), (257, 1), (257, 3)])
def test_fit_streaming_matches_the_jax_fit(tmp_path, chunk_rows, depth):
    path = write_drifted_window(tmp_path / "window.csv", rows=1200, seed=7)
    got = fit_streaming(path, chunk_rows=chunk_rows, reservoir_size=500,
                        pipeline_depth=depth)
    want = jax_fit_streaming(path, chunk_rows=chunk_rows, reservoir_size=500,
                             pipeline_depth=depth)
    for name in ("numeric_median", "numeric_mean", "numeric_std"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.schema_fingerprint == want.schema_fingerprint


# ------------------------------------------------------------------ /metrics
SNAPSHOTS = {
    "full": {
        "generation": 3, "drift_triggers": 2, "shadow_auc_delta": 0.0123,
        "promotions": {"promoted": 1, "rejected": 1, "rolled_back": 0},
        "reservoir_rows": 77, "breaker_open": True, "breaker_trips": 4,
    },
    "no_delta": {
        "generation": 2, "drift_triggers": 1, "shadow_auc_delta": None,
        "promotions": {"promoted": 1, "rejected": 0, "rolled_back": 1},
        "reservoir_rows": 5,
    },
    "bare": {"generation": 1, "drift_triggers": 0},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_lifecycle_block_is_the_jax_render_byte_for_byte(name):
    snapshot = SNAPSHOTS[name]
    want = ServingMetrics.lifecycle_lines(snapshot)
    assert port_metrics.lifecycle_lines(snapshot) == want
    metrics = Metrics()
    assert "mlops_tpu_bundle_generation" not in metrics.render({})
    metrics.set_lifecycle(snapshot)
    text = metrics.render({})
    if want:
        assert "\n".join(want) + "\n" in text
    else:
        assert "mlops_tpu_bundle_generation" not in text
