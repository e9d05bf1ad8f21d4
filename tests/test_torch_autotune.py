"""The port's traffic-shape autotuner (``mlops_tpu_torch/autotune/``)
against the JAX package's (``mlops_tpu/autotune/``), on the CPU.

- Torch-free units, bitwise: the cost-model fit (affine, single-point and
  non-physical fallbacks), the demand reconstruction from shape histograms
  and spans, the exact grid search over the JAX suite's eight seeded
  traces, plans crossing packages as JSON, and ``AutotuneConfig.validate``'s
  messages.
- The controller: a twin of each JAX stub-engine test
  (``tests/test_autotune.py``), both packages' controllers ticking twin
  stubs to the same status strings and snapshots.
- The real engine: a small bundle both packages load, regridded from
  (1, 8) to (1, 2, 8) on the quant and the exact tier, predictions within
  1e-6 of the JAX engine's after its own ``apply_plan``; the generations
  as JAX moves them (a shadow built before a regrid and promoted after it
  brings the old grid back); the ceiling refused with the JAX message; a
  promotion racing the warm aborts; a dispatch whose bucket came from the
  old grid replays an existing shape with no capture and no warm.
- The planes and the command: ``autotune_lines`` byte for byte the JAX
  render, the ring fold's MIN, the ``serve`` refusals word for word, both
  ``autotune`` commands on one ledger and span directory, the
  ``autotune.regrid.midswap`` kill survived in a subprocess, and a
  two-replica ring plane whose lead applies and whose sibling adopts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mlops_tpu.autotune import AutotuneController as JaxController
from mlops_tpu.autotune import apply_plan as jax_apply_plan
from mlops_tpu.autotune.apply import RegridAborted as JaxRegridAborted
from mlops_tpu.autotune.costmodel import demand_from_shapes as jax_demand_from_shapes
from mlops_tpu.autotune.costmodel import demand_from_spans as jax_demand_from_spans
from mlops_tpu.autotune.costmodel import fit_cost_model as jax_fit_cost_model
from mlops_tpu.autotune.costmodel import (
    ledger_rows_from_snapshot as jax_ledger_rows_from_snapshot,
)
from mlops_tpu.autotune.search import CostModel as JaxCostModel
from mlops_tpu.autotune.search import GridPlan as JaxGridPlan
from mlops_tpu.autotune.search import search_plan as jax_search_plan
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import AutotuneConfig as JaxAutotuneConfig
from mlops_tpu.config import AutotuneConfigError as JaxAutotuneConfigError
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.metrics import ServingMetrics as JaxServingMetrics
from mlops_tpu.trace.shapes import ShapeStats as JaxShapeStats
from mlops_tpu_torch import faults
from mlops_tpu_torch.autotune import (
    AutotuneController,
    CostModel,
    GridPlan,
    apply_plan,
    demand_from_shapes,
    demand_from_spans,
    fit_cost_model,
    ledger_rows_from_snapshot,
    search_plan,
    warm_plan,
)
from mlops_tpu_torch.autotune.apply import RegridAborted
from mlops_tpu_torch.autotune.costmodel import MEASURED_OVERHEAD_FRACTION
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import AutotuneConfig, AutotuneConfigError
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.ipc import RequestRing
from mlops_tpu_torch.serve.metrics import autotune_lines, render_ring_metrics
from mlops_tpu_torch.slo import CostLedger
from mlops_tpu_torch.trace.shapes import ShapeStats
from torch_ring import MODEL, ROOT, Plane, budget, exchange, make_bundle, records  # noqa: F401
from torch_threads import torch_threads  # noqa: F401


def _rows(points):
    """(size, mean_dispatch_s, dispatches) -> ledger report rows."""
    return [
        {"entry": f"bucket_{size}", "device_s": cost * weight, "dispatches": weight,
         "rows": size * weight, "padded_rows": size * weight}
        for size, cost, weight in points
    ]


def _noisy_rows(seed: int):
    rng = np.random.default_rng(seed)
    sizes = sorted(set(int(s) for s in rng.choice([1, 2, 3, 8, 16, 40, 64, 256], 5)))
    return _rows([(s, float(rng.uniform(1e-4, 5e-3)), float(rng.integers(1, 500)))
                  for s in sizes])


# ------------------------------------------------------------ cost model
FITS = {
    "affine": _rows([(s, 2e-3 + 1e-5 * s, 100.0) for s in (1, 8, 64, 256)]),
    "single_point": _rows([(64, 4e-3, 50.0)]),
    "nonphysical_slope": _rows([(1, 5e-3, 10.0), (256, 1e-3, 10.0)]),
    "negative_overhead": _rows([(8, 1e-4, 10.0), (64, 9e-3, 30.0)]),
    "no_solo": [{"entry": "group_8x8", "device_s": 1.0, "dispatches": 10.0,
                 "rows": 100.0, "padded_rows": 640.0}],
    "empty": [],
    "tiered": _rows([(8, 1e-3, 10.0)]) + [
        {"entry": "bucket_8@quant", "device_s": 9.0, "dispatches": 3.0,
         "rows": 9.0, "padded_rows": 24.0}],
    **{f"noisy_{seed}": _noisy_rows(seed) for seed in range(6)},
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_the_fit_is_the_jax_fit_bitwise(name):
    port, jax = fit_cost_model(FITS[name]), jax_fit_cost_model(FITS[name])
    if jax is None:
        assert port is None
        return
    assert port.as_dict() == jax.as_dict()
    assert port.dispatch_s(37) == jax.dispatch_s(37)


def test_the_fallbacks_keep_the_jax_split():
    model = fit_cost_model(FITS["single_point"])
    assert model.mode == "measured-affine" and model.points == 1
    assert model.a_s == 4e-3 * MEASURED_OVERHEAD_FRACTION
    assert fit_cost_model(FITS["nonphysical_slope"]).mode == "measured-affine"
    # A non-default tier's entry never enters the fit.
    assert fit_cost_model(FITS["tiered"]).as_dict() == fit_cost_model(
        _rows([(8, 1e-3, 10.0)])).as_dict()


def test_ledger_snapshots_fold_as_jax():
    snapshot = {"bucket_8@abc123": [1.0, 10.0, 60.0, 80.0],
                "bucket_8@def456": [3.0, 30.0, 180.0, 240.0],
                "group_8x8": [1.0, 1.0, 8.0, 64.0], "bucket_8@quant": [2.0, 1.0, 2.0, 8.0]}
    assert ledger_rows_from_snapshot(snapshot) == jax_ledger_rows_from_snapshot(snapshot)


# ---------------------------------------------------------------- demand
def _observe_both(seed: int, n: int, ceiling: int = 256):
    rng = np.random.default_rng(seed)
    port, jax = ShapeStats(), JaxShapeStats()
    for _ in range(n):
        rows = int(min(np.exp(rng.uniform(0, np.log(ceiling))), ceiling))
        padded = min(next(b for b in (1, 8, 64, 256, 1024) if b >= rows), ceiling)
        for stats in (port, jax):
            stats.observe(f"bucket_{padded}", rows, padded)
    for stats in (port, jax):
        stats.observe("group_8x8", 5, 64)
        stats.observe("bucket_8@quant", 3, 8)
    return port, jax


@pytest.mark.parametrize("seed", range(4))
def test_demand_from_shapes_is_the_jax_demand(seed):
    port, jax = _observe_both(seed, 50 + 100 * seed)
    snap = port.snapshot()
    assert snap == jax.snapshot()
    demand = demand_from_shapes(snap)
    assert demand == jax_demand_from_shapes(jax.snapshot())
    assert sum(w for _, w in demand) == 50 + 100 * seed


def test_demand_from_spans_is_the_jax_demand():
    rng = np.random.default_rng(5)
    spans = [{"kind": "span", "entry": str(rng.choice(["bucket_8", "bucket_64", "group_8x8",
                                                       "bucket_1@quant"])),
              "rows": int(rng.integers(0, 60))} for _ in range(300)]
    assert demand_from_spans(spans) == jax_demand_from_spans(spans)
    assert demand_from_spans([{"entry": "bucket_8", "rows": 3}] * 2) == [(3, 2.0)]


# ---------------------------------------------------------------- search
COST = dict(a_s=2e-3, b_s=1e-5, points=4, mode="affine-fit")


@pytest.mark.parametrize("seed", range(8))
def test_the_search_is_the_jax_search_on_the_seeded_traces(seed):
    """The JAX suite's eight coverage traces: the same plan, bucket for
    bucket and float for float, and it covers every observed shape."""
    rng = np.random.default_rng(seed)
    port, jax = ShapeStats(), JaxShapeStats()
    ceiling = int(rng.choice([64, 256, 1024]))
    for _ in range(int(rng.integers(50, 400))):
        n = int(min(np.exp(rng.uniform(0, np.log(ceiling))), ceiling))
        padded = min(next(b for b in (1, 8, 64, 256, 1024) if b >= n), ceiling)
        port.observe(f"bucket_{padded}", n, padded)
        jax.observe(f"bucket_{padded}", n, padded)
    demand = demand_from_shapes(port.snapshot())
    max_entries = int(rng.integers(2, 17))
    plan = search_plan(demand, CostModel(**COST), (1, 8, ceiling), max_entries)
    want = jax_search_plan(jax_demand_from_shapes(jax.snapshot()), JaxCostModel(**COST),
                           (1, 8, ceiling), max_entries)
    assert plan.as_dict() == want.as_dict()
    assert plan.buckets[-1] == ceiling and len(plan.buckets) <= max_entries
    assert all(any(b >= min(r, ceiling) for b in plan.buckets) for r, _ in demand)


def test_a_flat_cost_ledger_predicts_the_jax_gain():
    """ROADMAP C9, pinned until it is mended in both packages: on a ledger
    whose buckets all cost the same per dispatch (the H100's graph
    replays of the quant tier at 1-256 rows), the fit falls back to the
    measured-affine split, and the search predicts a large gain for a
    grid that cannot change the device time of a dispatch, so the true
    gain in useful rows per device-second is 0. Phase 36's skewed demand:
    85 % of requests 2-3 records, 10 % one, 5 % 30-40."""
    flat = _rows([(1, 40e-6, 400.0), (8, 40e-6, 3400.0), (64, 40e-6, 200.0),
                  (256, 40e-6, 5.0)])
    port_model, jax_model = fit_cost_model(flat), jax_fit_cost_model(flat)
    assert port_model.as_dict() == jax_model.as_dict()
    assert port_model.mode == "measured-affine"
    assert port_model.a_s == 40e-6 * MEASURED_OVERHEAD_FRACTION
    rng = np.random.default_rng(36)
    port, jax = ShapeStats(), JaxShapeStats()
    for _ in range(4000):
        u = rng.random()
        n = int(rng.integers(2, 4)) if u < 0.85 else 1 if u < 0.95 else int(rng.integers(30, 41))
        padded = next(b for b in (1, 8, 64, 256) if b >= n)
        port.observe(f"bucket_{padded}", n, padded)
        jax.observe(f"bucket_{padded}", n, padded)
    grid = (1, 8, 64, 256)
    plan = search_plan(demand_from_shapes(port.snapshot()), port_model, grid, 8)
    want = jax_search_plan(jax_demand_from_shapes(jax.snapshot()), jax_model, grid, 8)
    assert plan.as_dict() == want.as_dict()
    assert plan.buckets[-1] == 256 and plan.buckets != list(grid)
    # The fault: every dispatch costs 40 us on either grid, yet the plan
    # claims most of a doubling.
    assert plan.predicted_gain_pct > 50.0


def test_plans_cross_the_packages_as_json():
    demand = [(3, 900.0), (12, 80.0), (200, 15.0), (256, 5.0)]
    model = dict(a_s=1e-3, b_s=1e-4, points=4, mode="affine-fit")
    plan = search_plan(demand, CostModel(**model), (1, 8, 64, 256), 16)
    jax_plan = jax_search_plan(demand, JaxCostModel(**model), (1, 8, 64, 256), 16)
    text, jax_text = json.dumps(plan.as_dict()), json.dumps(jax_plan.as_dict())
    assert text == jax_text and json.loads(text)["format"] == 1
    assert GridPlan.from_dict(json.loads(jax_text)) == plan
    assert JaxGridPlan.from_dict(json.loads(text)) == jax_plan
    assert plan.predicted_gain_pct > 5.0 and plan.buckets[-1] == 256


# ---------------------------------------------------------------- config
BAD_CONFIGS = {
    "interval": dict(interval_s=0),
    "dispatches": dict(min_dispatches=0),
    "entries": dict(max_entries=1),
    "gain": dict(min_gain_pct=-1.0),
    "cooldown": dict(cooldown_s=-1.0),
    "plan_dir": dict(enabled=True, plan_dir=""),
    "several": dict(interval_s=-1, max_entries=0, cooldown_s=-2.0),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_autotune_config_refuses_with_the_jax_messages(name):
    kw = BAD_CONFIGS[name]
    with pytest.raises(JaxAutotuneConfigError) as want:
        JaxAutotuneConfig(**kw).validate()
    with pytest.raises(AutotuneConfigError) as got:
        AutotuneConfig(**kw).validate()
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_autotune_config_defaults_are_the_jax_defaults():
    assert dataclasses.asdict(AutotuneConfig()) == dataclasses.asdict(JaxAutotuneConfig())
    assert AutotuneConfig().validate() == AutotuneConfig()


# ------------------------------------------------------------ controller
class _StubLedger:
    def __init__(self):
        self.entries = {}

    def snapshot(self):
        return {k: list(v) for k, v in self.entries.items()}


class _StubEngine:
    monitor_accumulating = True

    def __init__(self, stats, buckets=(1, 8, 64, 256)):
        self.buckets = tuple(buckets)
        self.grid_generation = 0
        self.bundle_generation = 0
        self.shape_stats = stats
        self.cost_ledger = _StubLedger()
        self.rolled_back = 0

    def rollback(self):
        self.rolled_back += 1
        self.grid_generation += 1

    def feed(self, demand, ledger=True):
        for rows, weight in demand:
            padded = next((b for b in self.buckets if b >= rows), self.buckets[-1])
            for _ in range(int(weight)):
                self.shape_stats.observe(f"bucket_{padded}", rows, padded)
        if ledger:
            self.seed_ledger()

    def seed_ledger(self):
        model = CostModel(**COST)
        for b in self.buckets:
            self.cost_ledger.entries.setdefault(
                f"bucket_{b}", [model.dispatch_s(b) * 100, 100.0, b * 100.0, b * 100.0])


def _fake_apply(eng, buckets, workers=0):
    eng.buckets = tuple(buckets)
    eng.grid_generation += 1
    return eng.grid_generation


class _Twins:
    """The same stub scenario under both packages' controllers, each in
    its own plan directory; ``tick`` runs both and checks they agree."""

    def __init__(self, tmp_path, monkeypatch, adopt=False, replica=0, plan_root=None,
                 **kw):
        monkeypatch.setattr("mlops_tpu.autotune.apply.apply_plan", _fake_apply)
        monkeypatch.setattr("mlops_tpu_torch.autotune.apply.apply_plan", _fake_apply)
        kw.setdefault("min_dispatches", 10)
        self.engines, self.controllers = [], []
        for side, (stats, config, controller) in {
            "port": (ShapeStats, AutotuneConfig, AutotuneController),
            "jax": (JaxShapeStats, JaxAutotuneConfig, JaxController),
        }.items():
            root = (plan_root or tmp_path) / side
            engine = _StubEngine(stats())
            self.engines.append(engine)
            self.controllers.append(controller(
                engine, config(enabled=True, plan_dir=str(root / "autotune"), **kw).validate(),
                adopt=adopt, replica=replica))

    def do(self, fn):
        for engine in self.engines:
            fn(engine)

    def tick(self, now):
        port, jax = (c.run_once(now=now) for c in self.controllers)
        assert port == jax
        snaps = [c.metrics_snapshot() for c in self.controllers]
        assert snaps[0] == snaps[1]
        return port

    def plan_docs(self, tmp_path):
        return [json.loads((tmp_path / side / "autotune" / "plan.json").read_text())
                for side in ("port", "jax")]


def test_controller_holds_then_plans_dry_run(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch, apply=False, min_gain_pct=1.0)
    assert twins.tick(0.0) == "held: 0 dispatches < min"
    twins.do(lambda e: e.feed([(3, 900.0), (200, 20.0)]))
    assert twins.tick(1.0).startswith("planned (dry-run)")
    port, jax = twins.plan_docs(tmp_path)
    assert port == jax and port["applied"] is False and port["buckets"][-1] == 256
    snap = twins.controllers[0].metrics_snapshot()
    assert snap["plans"]["planned"] == 1 and snap["predicted_gain_pct"] > 1.0


def test_controller_disarmed_without_telemetry(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch)
    twins.do(lambda e: setattr(e, "shape_stats", None))
    assert twins.tick(0.0) == "disarmed"


def test_controller_rejects_subthreshold_gains(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch, min_gain_pct=1e6)
    twins.do(lambda e: e.feed([(3, 900.0), (200, 20.0)]))
    assert twins.tick(0.0).startswith("rejected: gain")
    assert twins.controllers[0].metrics_snapshot()["plans"]["rejected"] == 1


def test_controller_applies_then_cools_down(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch, min_gain_pct=1.0, cooldown_s=100.0)
    twins.do(lambda e: e.feed([(3, 900.0), (200, 20.0)]))
    assert twins.tick(0.0) == "applied: grid_generation=1"
    assert twins.engines[0].buckets == twins.engines[1].buckets
    assert twins.engines[0].buckets[-1] == 256
    assert twins.tick(50.0) == "cooling"
    assert twins.tick(200.0) != "cooling"
    port, jax = twins.plan_docs(tmp_path)
    assert port == jax and port["applied"] is True and port["grid_generation"] == 1


def test_sibling_adopts_the_leads_applied_plan(tmp_path, monkeypatch):
    lead = _Twins(tmp_path, monkeypatch, min_gain_pct=1.0)
    lead.do(lambda e: e.feed([(3, 900.0), (200, 20.0)]))
    assert lead.tick(0.0).startswith("applied")
    sibling = _Twins(tmp_path, monkeypatch, adopt=True, replica=1, min_gain_pct=1.0)
    assert sibling.tick(0.0) == "adopted: grid_generation=1"
    assert sibling.engines[0].buckets == lead.engines[0].buckets
    assert sibling.tick(1.0) == "adopt: current"
    # A plan written by either package is adopted by the other.
    (tmp_path / "port" / "autotune" / "plan.json").write_text(
        (tmp_path / "jax" / "autotune" / "plan.json").read_text())
    fresh = AutotuneController(_StubEngine(ShapeStats()), AutotuneConfig(
        enabled=True, plan_dir=str(tmp_path / "port" / "autotune")), adopt=True, replica=1)
    assert fresh.run_once(now=0.0) == "adopted: grid_generation=1"


def test_adopt_without_plan_is_a_noop(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch, adopt=True, replica=1)
    assert twins.tick(0.0) == "adopt: no plan"


def test_controller_rollback_counts_and_restores(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch)
    port, jax = (c.rollback() for c in twins.controllers)
    assert port == jax == "rolled_back: grid_generation=1"
    assert [e.rolled_back for e in twins.engines] == [1, 1]
    assert twins.controllers[0].metrics_snapshot() == twins.controllers[1].metrics_snapshot()
    assert twins.controllers[0].metrics_snapshot()["plans"]["rolled_back"] == 1


def test_measured_gain_audit_from_ledger_deltas(tmp_path, monkeypatch):
    twins = _Twins(tmp_path, monkeypatch, min_gain_pct=1.0, cooldown_s=0.0)
    twins.do(lambda e: e.seed_ledger())
    twins.tick(0.0)
    twins.do(lambda e: e.feed([(3, 900.0), (200, 20.0)], ledger=False))

    def grow(factor):
        def fn(engine):
            engine.cost_ledger.entries["bucket_8"][0] += 1.0
            engine.cost_ledger.entries["bucket_8"][2] += 500.0 * factor
        return fn

    twins.do(grow(1))
    assert twins.tick(1.0).startswith("applied")
    twins.do(grow(2))
    assert twins.tick(2.0).startswith("rejected")
    snap = twins.controllers[0].metrics_snapshot()
    assert snap["measured_gain_pct"] == pytest.approx(100.0, rel=0.01)
    assert twins.controllers[0].status()["last_plan"] == twins.controllers[1].status()["last_plan"]


def test_warm_plan_refuses_a_non_accumulating_engine():
    class _Sklearn:
        monitor_accumulating = False

    from mlops_tpu.autotune import warm_plan as jax_warm_plan

    with pytest.raises(ValueError) as want:
        jax_warm_plan(_Sklearn(), (1, 8))
    with pytest.raises(ValueError) as got:
        warm_plan(_Sklearn(), (1, 8))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- real-engine path
@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("autotune"))


@pytest.fixture(scope="module")
def f32_bundle_dir(tmp_path_factory):
    """The exact tier at f32, where the two packages agree within 1e-6
    (at bf16 they agree within bf16 ulps only)."""
    return make_bundle(tmp_path_factory.mktemp("autotune_f32"), seed=3,
                       model=dict(MODEL, precision="f32"), quant=False)


def _request(n: int, seed: int = 7) -> list[dict]:
    return records(n, seed=seed, drift=0.2)


@pytest.mark.parametrize("tier", ["quant", "exact"])
def test_a_regrid_answers_as_the_jax_engines_regrid(bundle_dir, f32_bundle_dir, tier):
    path = bundle_dir if tier == "quant" else f32_bundle_dir
    engine = InferenceEngine(load_bundle(path), buckets=(1, 8), serve_tier=tier,
                             device="cpu")
    engine.warmup()
    jax_engine = JaxEngine(jax_load_bundle(path), buckets=(1, 8), serve_tier=tier,
                           enable_grouping=False)
    jax_engine.warmup()
    request = _request(2)
    before = engine.predict_records(request)
    assert apply_plan(engine, (1, 2, 8)) == jax_apply_plan(jax_engine, (1, 2, 8)) == 2
    assert list(engine.buckets) == list(jax_engine.buckets) == [1, 2, 8]
    assert engine.bundle_generation == jax_engine.bundle_generation == 2
    assert engine.swap_stats["op"] == "regrid" and engine.swap_stats["graphs"] == 1
    after, want = engine.predict_records(request), jax_engine.predict_records(request)
    assert np.abs(np.subtract(after["predictions"], want["predictions"])).max() <= 1e-6
    assert np.abs(np.subtract(after["predictions"], before["predictions"])).max() <= 1e-6
    assert engine.dispatch_counts().get("bucket_2") == 1
    assert engine.rollback() == jax_engine.rollback() == 3
    assert engine.grid_generation == jax_engine.grid_generation == 3
    assert list(engine.buckets) == [1, 8]
    restored = engine.predict_records(request)
    assert np.abs(np.subtract(restored["predictions"], before["predictions"])).max() <= 1e-6


def test_the_generations_move_as_the_jax_engines(bundle_dir):
    """Regrid, rollback, roll forward, then a promotion of a shadow built
    before the regrid: it brings the old bucket list back, and the grid
    generation moves as the JAX engine's does (the pinned behaviour, not
    mended)."""
    port_bundle, jax_bundle = load_bundle(bundle_dir), jax_load_bundle(bundle_dir)
    port = InferenceEngine(port_bundle, buckets=(1, 8), device="cpu")
    jax = JaxEngine(jax_bundle, buckets=(1, 8), enable_grouping=False)
    for engine in (port, jax):
        engine.warmup()
    shadow = InferenceEngine(port_bundle, buckets=(1, 8), device="cpu")
    jax_shadow = JaxEngine(jax_bundle, buckets=(1, 8), enable_grouping=False)
    shadow.warmup()
    jax_shadow.warmup()
    seen = []
    for step in ("regrid", "rollback", "rollforward", "promote", "same_grid"):
        for engine, twin, regrid in ((port, shadow, apply_plan), (jax, jax_shadow,
                                                                   jax_apply_plan)):
            if step == "regrid":
                regrid(engine, (1, 3, 8))
            elif step in ("rollback", "rollforward"):
                engine.rollback()
            elif step == "promote":
                engine.swap_bundle(twin)
            else:
                regrid(engine, tuple(engine.buckets))
        seen.append((step, port.grid_generation, port.bundle_generation, list(port.buckets)))
        assert (jax.grid_generation, jax.bundle_generation) == seen[-1][1:3], step
        assert list(jax.buckets) == seen[-1][3], step
    assert seen[3] == ("promote", 5, 5, [1, 8])
    assert seen[4] == ("same_grid", 5, 6, [1, 8])


def test_a_promotion_after_a_regrid_keeps_the_regridded_grid(bundle_dir):
    from mlops_tpu_torch.lifecycle.shadow import ShadowEngine

    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    engine.warmup()
    apply_plan(engine, (1, 2, 8))
    shadow = ShadowEngine(engine, load_bundle(bundle_dir))
    assert list(shadow.engine.buckets) == [1, 2, 8]
    shadow.warm()
    engine.swap_bundle(shadow.engine)
    assert list(engine.buckets) == [1, 2, 8] and engine.grid_generation == 2


def test_the_ceiling_is_refused_with_the_jax_message(bundle_dir):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    engine.warmup()
    jax_engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8), enable_grouping=False)
    jax_engine.warmup()
    with pytest.raises(ValueError) as want:
        jax_apply_plan(jax_engine, (1, 4))
    warmed = set(engine._gen.warmed)
    with pytest.raises(ValueError) as got:
        apply_plan(engine, (1, 4))
    assert str(got.value) == str(want.value)
    assert engine._gen.warmed == warmed  # refused before any warm
    assert engine.grid_generation == 1 and list(engine.buckets) == [1, 8]
    with pytest.raises(ValueError, match="not ready; warm_grid first"):
        engine.regrid((1, 5, 8))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_promotion_racing_the_warm_aborts_the_regrid(bundle_dir, monkeypatch, package):
    if package == "port":
        engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
        module, regrid, aborted = ("mlops_tpu_torch.autotune.apply", apply_plan,
                                   RegridAborted)
    else:
        engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8), enable_grouping=False)
        module, regrid, aborted = "mlops_tpu.autotune.apply", jax_apply_plan, JaxRegridAborted
    engine.warmup()

    def racing_warm(engine, buckets, workers=0):
        engine.bundle_generation += 1  # a promotion landed mid-warm
        return 0

    monkeypatch.setattr(f"{module}.warm_plan", racing_warm)
    with pytest.raises(aborted, match="bundle generation moved 1 -> 2 during warm"):
        regrid(engine, (1, 2, 8))
    assert engine.grid_generation == 1 and list(engine.buckets) == [1, 8]


@pytest.mark.parametrize("tier_routing", [False, True])
def test_the_warm_readies_every_tier_and_only_what_is_missing(bundle_dir, tier_routing):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu",
                             tier_routing=tier_routing)
    engine.warmup()
    tiers = len(engine.available_tiers)
    assert tiers == (2 if tier_routing else 1)
    assert warm_plan(engine, (1, 3, 17, 64)) == 2 * tiers
    assert warm_plan(engine, (1, 3, 17, 64)) == 0
    assert apply_plan(engine, (1, 3, 17, 64)) == 2
    assert engine.swap_stats["graphs"] == 0
    for tier in engine.available_tiers:
        assert {(tier, (b,)) for b in (1, 3, 8, 17, 64)} <= engine._gen.warmed
    if tier_routing:
        answer = engine.predict_records(_request(3), tier="quant")
        assert engine.dispatch_counts().get("bucket_3@quant") == 1
        assert len(answer["predictions"]) == 3


def test_a_dispatch_that_raced_the_exchange_needs_no_capture(bundle_dir, monkeypatch):
    """A request that picked bucket 4 from the old grid (1, 4, 8) and takes
    the lock after the exchange to (1, 2, 8): it runs bucket 4 in the new
    generation, a shape the generations share, with no capture, no warm
    and no degraded fallback (a compile fault armed would fire first)."""
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 4, 8), serve_tier="quant",
                             device="cpu")
    engine.warmup()
    request = _request(3)
    want = engine.predict_records_wire(request)
    apply_plan(engine, (1, 2, 8))
    assert list(engine.buckets) == [1, 2, 8]
    warmed = set(engine._gen.warmed)
    monkeypatch.setattr(engine, "_bucket_for", lambda n: 4)  # the stale read
    passes = []
    monkeypatch.setattr(engine, "_warm_pass", lambda *a: passes.append(a))
    plan = faults.arm(faults.FaultPlan.from_rules(
        [{"point": "serve.engine.compile", "mode": "raise"}]))
    try:
        got = engine.predict_records_wire(request)
    finally:
        faults.disarm()
    assert engine.dispatch_counts() == {"bucket_4": 2}
    assert plan.trace() == [] and passes == []
    assert engine.degraded_dispatch_total == 0
    assert engine._gen.warmed == warmed
    assert got == want  # the same shape and generation state: the same bytes


def test_dispatch_threads_racing_regrids_never_capture(bundle_dir):
    """Eight threads dispatch 2- to 5-row requests while the main thread
    regrids between (1, 4, 8) and (1, 2, 3, 8) and rolls back, with a tiny
    switch interval: every answer is the reference's, no dispatch readies
    a shape (a compile fault armed would fire first), and the monitor
    aggregate counts every row exactly once."""
    import threading

    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 4, 8), serve_tier="quant",
                             device="cpu")
    engine.warmup()
    requests = [_request(n, seed=50 + n) for n in (2, 3, 4, 5)]
    want = [engine.predict_records(r)["predictions"] for r in requests]
    warm_plan(engine, (1, 2, 3, 8))
    plan = faults.arm(faults.FaultPlan.from_rules(
        [{"point": "serve.engine.compile", "mode": "raise"}]))
    errors, rows = [], [0] * 8
    stop = threading.Event()

    def client(k):
        i = 0
        while not stop.is_set():
            j = (i + k) % len(requests)
            got = engine.predict_records(requests[j])["predictions"]
            if np.abs(np.subtract(got, want[j])).max() > 1e-6:
                errors.append((k, j, got))
            rows[k] += len(requests[j])
            i += 1

    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before = engine.monitor_snapshot()["rows"]
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for _ in range(20):
            apply_plan(engine, (1, 2, 3, 8))
            engine.rollback()
            engine.rollback()
            apply_plan(engine, (1, 4, 8))
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        sys.setswitchinterval(previous)
        faults.disarm()
    assert errors == [] and plan.trace() == []
    assert engine.degraded_dispatch_total == 0
    assert engine.monitor_snapshot()["rows"] - before == sum(rows) > 0
    assert engine.grid_generation == 1 + 4 * 20 and list(engine.buckets) == [1, 4, 8]


# ------------------------------------------------------ metrics and planes
SNAPSHOTS = {
    "fresh": {"grid_generation": 1, "plans": {}, "predicted_gain_pct": None,
              "measured_gain_pct": None},
    "planned": {"grid_generation": 1, "plans": {"planned": 2, "rejected": 1},
                "predicted_gain_pct": 7.123456, "measured_gain_pct": None},
    "applied": {"grid_generation": 3, "plans": {"applied": 2, "rolled_back": 1, "failed": 4},
                "predicted_gain_pct": 0.0, "measured_gain_pct": -12.5},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_autotune_lines_are_the_jax_lines(name):
    assert autotune_lines(SNAPSHOTS[name]) == JaxServingMetrics.autotune_lines(
        SNAPSHOTS[name])


def _block(text: str) -> list[str]:
    return [line for line in text.splitlines() if "grid_generation" in line
            or "autotune" in line]


def test_the_ring_folds_the_replicas_min_and_sums_the_plans():
    ring = RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8, replicas=3)
    try:
        assert _block(render_ring_metrics(ring)) == []
        ring.write_autotune(SNAPSHOTS["applied"] | {"grid_generation": 2}, replica=0)
        ring.write_autotune(SNAPSHOTS["planned"], replica=2)
        want = {"grid_generation": 1,
                "plans": {"applied": 2, "planned": 2, "rejected": 1, "rolled_back": 1,
                          "failed": 4},
                "predicted_gain_pct": 0.0, "measured_gain_pct": -12.5}
        assert _block(render_ring_metrics(ring)) == JaxServingMetrics.autotune_lines(want)
        ring.write_autotune(SNAPSHOTS["planned"] | {"grid_generation": 2}, replica=2)
        assert "mlops_tpu_grid_generation 2" in _block(render_ring_metrics(ring))
    finally:
        ring.close()


REFUSALS = {
    "trace": ([], "autotune.enabled requires trace.enabled"),
    "ledger": (["trace.enabled=true"], "autotune.enabled requires slo.ledger_dir"),
    "tenants": (["trace.enabled=true", "slo.ledger_dir=LEDGER",
                 f"serve.tenants_path={ROOT / 'configs' / 'tenants.toml'}"],
                "autotune.enabled supports single-tenant planes only"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
@pytest.mark.parametrize("workers", ["0", "2"])
def test_serve_refuses_as_jax_on_both_planes(case, workers, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    extra, start = REFUSALS[case]
    args = ["serve", "autotune.enabled=true", f"serve.workers={workers}",
            *(a.replace("LEDGER", str(tmp_path / "ledger")) for a in extra)]
    with pytest.raises(SystemExit) as want:
        jax_main(args)
    with pytest.raises(SystemExit) as got:
        main(args)
    assert str(got.value) == str(want.value) and str(got.value).startswith(start)


def _telemetry(root, demand, costs):
    """A ledger shard (``CostLedger``) and a span file both packages read."""
    ledger = CostLedger(root / "ledger")
    for size, seconds, n in costs:
        for _ in range(n):
            ledger.observe(f"bucket_{size}", "abc12345", size // 2 or 1, size, seconds)
    ledger.close()
    (root / "traces").mkdir()
    with open(root / "traces" / "spans.jsonl", "w") as f:
        for rows, n in demand:
            for _ in range(n):
                f.write(json.dumps({"kind": "span", "entry": "bucket_8", "rows": rows}) + "\n")


def _both_commands(capsys, args):
    out = []
    for run in (jax_main, main):
        try:
            rc = run(["autotune", *args])
        except SystemExit as err:
            rc = f"SystemExit: {err}"
        out.append((rc, capsys.readouterr().out.strip().splitlines()))
    return out


@pytest.mark.parametrize("case", ["warranted", "not_warranted", "ledger_only"])
def test_both_autotune_commands_print_the_same_plan(tmp_path, capsys, case):
    costs = [(1, 1e-3, 40), (8, 2e-3, 60), (64, 9e-3, 20)]
    demand = {"warranted": [(3, 50), (2, 30), (40, 10)],
              "not_warranted": [(1, 30), (8, 50), (64, 10)], "ledger_only": []}[case]
    _telemetry(tmp_path, demand, costs)
    args = [f"slo.ledger_dir={tmp_path / 'ledger'}", f"trace.dir={tmp_path / 'traces'}",
            "serve.warmup_batch_sizes=1,8,64,256"]
    (jax_rc, jax_out), (rc, out) = _both_commands(capsys, args)
    assert (rc, out) == (jax_rc, jax_out) and len(out) == 1
    doc = json.loads(out[0])
    assert rc == (0 if doc["regrid_warranted"] else 3)
    assert rc == {"warranted": 0, "not_warranted": 3, "ledger_only": rc}[case]
    assert doc["buckets"][-1] == 256


def test_both_autotune_commands_refuse_alike(tmp_path, capsys):
    no_dir = _both_commands(capsys, [])
    assert no_dir[0] == no_dir[1] and "needs slo.ledger_dir" in no_dir[0][0]
    ledger = CostLedger(tmp_path / "ledger")
    ledger.observe("group_8x8", "abc12345", 5, 64, 1e-3)
    ledger.close()
    no_solo = _both_commands(capsys, [f"slo.ledger_dir={tmp_path / 'ledger'}"])
    assert no_solo[0] == no_solo[1] and "no solo bucket_N entries" in no_solo[0][0]


MIDSWAP = """
import json, sys
from mlops_tpu_torch import faults
from mlops_tpu_torch.autotune import apply_plan
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.serve.engine import InferenceEngine
engine = InferenceEngine(load_bundle(sys.argv[1]), buckets=(1, 8), serve_tier="quant",
                         device="cpu")
engine.warmup()
request = json.loads(sys.argv[2])
out = {"old": engine.predict_records(request), "entries": [engine.dispatch_counts()]}
if sys.argv[3] == "kill":
    faults.arm(faults.FaultPlan.from_rules(
        [{"point": "autotune.regrid.midswap", "mode": "kill"}]))
    apply_plan(engine, (1, 2, 8))
    raise SystemExit("the kill fault did not fire")
out["generation"] = apply_plan(engine, (1, 2, 8))
out["new"] = engine.predict_records(request)
out["entries"].append(engine.dispatch_counts())
engine.rollback()
out["rolled_back"] = engine.predict_records(request)
out["entries"].append(engine.dispatch_counts())
out["grid_generation"] = engine.grid_generation
print(json.dumps(out))
"""


def test_a_kill_at_midswap_is_survived_by_a_fresh_process(bundle_dir):
    request = json.dumps(_request(2))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    killed = subprocess.run([sys.executable, "-c", MIDSWAP, str(bundle_dir), request, "kill"],
                            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert killed.returncode == -9, killed.stderr[-2000:]
    fresh = subprocess.run([sys.executable, "-c", MIDSWAP, str(bundle_dir), request, "run"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert fresh.returncode == 0, fresh.stderr[-2000:]
    out = json.loads(fresh.stdout.strip().splitlines()[-1])
    assert out["generation"] == 2 and out["grid_generation"] == 3
    assert out["entries"] == [{"bucket_8": 1}, {"bucket_8": 1, "bucket_2": 1},
                              {"bucket_8": 2, "bucket_2": 1}]
    for key in ("new", "rolled_back"):
        assert np.abs(np.subtract(out[key]["predictions"],
                                  out["old"]["predictions"])).max() <= 1e-6


@pytest.mark.parametrize("plane_kind", ["single", "ring"])
def test_the_lead_regrids_and_the_sibling_adopts(bundle_dir, tmp_path, plane_kind):
    """A plane armed through the config, the single-process server or a
    two-worker, two-replica ring: the (lead replica's) controller plans
    and applies after warmup; on the ring the sibling adopts on a later
    tick, and ``/metrics`` reads ``mlops_tpu_grid_generation 2`` (on the
    ring the MIN over the replicas). Every answer of the requests sent
    across the regrid is 200, within 1e-6 of the JAX engine's; SIGTERM
    stops the controllers and the plane exits 0."""
    ring = plane_kind == "ring"
    plane = Plane(bundle_dir, tmp_path / "plane.log", (
        *(("serve.workers=2", "serve.engine_replicas=2") if ring else ()),
        "serve.serve_tier=quant",
        "trace.enabled=true", f"trace.dir={tmp_path / 'traces'}",
        f"slo.ledger_dir={tmp_path / 'ledger'}", "autotune.enabled=true",
        "autotune.interval_s=0.25", "autotune.min_dispatches=20",
        "autotune.min_gain_pct=0", "autotune.cooldown_s=600",
        f"autotune.plan_dir={tmp_path / 'autotune'}"), wait=False)
    try:
        jax_engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64),
                               serve_tier="quant", enable_grouping=False)
        jax_engine.warmup()
        bodies = [_request(n, seed=k) for k, n in enumerate([2, 3, 2, 3, 1, 2, 3, 30] * 5)]
        wants = [jax_engine.predict_records(b)["predictions"] for b in bodies]
        plane.wait_ready(120)
        deadline = time.monotonic() + 90
        # Every controller armed (its row written) before the traffic: the
        # fold's MIN covers the armed replicas only.
        while plane.text().count("autotune controller started") < (2 if ring else 1):
            assert time.monotonic() < deadline, plane.text()[-3000:]
            time.sleep(0.05)
        grid = 0.0
        while grid < 2:
            for body, want in zip(bodies, wants):
                status, _, answer = exchange(plane.port, "POST", "/predict", body)
                assert status == 200, answer[:200]
                got = json.loads(answer)["predictions"]
                assert np.abs(np.subtract(got, want)).max() <= 1e-6
            text = exchange(plane.port, "GET", "/metrics")[2].decode()
            grid = next((float(line.split()[1]) for line in text.splitlines()
                         if line.startswith("mlops_tpu_grid_generation ")), 0.0)
            assert time.monotonic() < deadline, plane.text()[-3000:]
        # The controller writes the plan after ``apply_plan`` returns, so
        # the grid generation can show before the file does.
        plan_path = tmp_path / "autotune" / "plan.json"
        while not plan_path.exists():
            assert time.monotonic() < deadline, plane.text()[-3000:]
            time.sleep(0.05)
        plan = json.loads(plan_path.read_text())
        assert plan["applied"] and plan["replica"] == 0 and plan["buckets"][-1] == 64
        assert 'mlops_tpu_autotune_plans_total{outcome="applied"}' in text
        log = plane.text()
        assert "autotune regrid applied" in log
        if ring:
            assert "autotune regrid adopted" in log and "(replica 1, adopt mode)" in log
        else:
            assert "autotune controller started" in log
    finally:
        assert plane.stop() == 0
