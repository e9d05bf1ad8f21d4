"""The lifecycle loop on the ring plane (engine side) against the JAX
package, on the CPU:

- the ring's lifecycle row renders byte for byte as the JAX ring render
  of the same snapshot;
- a re-attaching engine carries the dead incarnation's lifecycle
  counters as bases, so drift triggers, breaker trips and promotions
  never go back while the generation is the new controller's; the
  telemetry thread mirrors the controller with the monitor cadence off;
- a job routed to the quant tier just before a promotion to a bundle
  without one counts under the tier that served it;
- the engine-side controller over an in-process ring (a ``RingService``
  on the port's CPU engine, requests through a ``RingClient``,
  ``run_once`` on a clock) makes the JAX controller's decisions, and
  ``lifecycle.retrain`` raises open the breaker in both packages alike;
- end to end: ``serve --config configs/lifecycle_serve.toml
  serve.workers=2`` in a subprocess armed through ``MLOPS_TPU_FAULTS``:
  two injected retrain failures open the breaker (gauges on every front
  end), the next candidate is promoted under traffic with no non-200,
  both front ends read generation 2, a kill -9 of the engine serves the
  fork-time bundle at generation 1 with every counter monotone, and the
  drain exits 0.
"""

import asyncio
import json
import os
import re
import signal
import threading
import time

import numpy as np
import pytest

from mlops_tpu import faults as jax_faults
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.lifecycle import LifecycleController as JaxController
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.ipc import RequestRing as JaxRing
from mlops_tpu.serve.metrics import render_ring_metrics as jax_render_ring_metrics
from mlops_tpu_torch import faults
from mlops_tpu_torch.lifecycle.controller import LifecycleController
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.ipc import RequestRing, RingClient, RingService
from mlops_tpu_torch.serve.metrics import LIFE_HAS, render_ring_metrics
from test_torch_lifecycle_loop import _drive, _no_latency_gate
from torch_lifecycle import (  # noqa: F401
    budget,
    feed,
    jax_config,
    port_config,
    scenery,
    traffic,
)
from torch_ring import ROOT, Plane, exchange, records
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

SNAPSHOTS = {
    "full": {
        "generation": 3, "drift_triggers": 2, "shadow_auc_delta": 0.0123456,
        "promotions": {"promoted": 2, "rejected": 1, "rolled_back": 1},
        "reservoir_rows": 77, "breaker_open": True, "breaker_trips": 4,
    },
    "zero_delta": {
        "generation": 2, "drift_triggers": 1, "shadow_auc_delta": 0.0,
        "promotions": {"promoted": 1}, "reservoir_rows": 0, "breaker_open": False,
        "breaker_trips": 0,
    },
    "no_delta": {
        "generation": 2, "drift_triggers": 1, "shadow_auc_delta": None,
        "promotions": {"promoted": 1, "rejected": 0, "rolled_back": 1},
        "reservoir_rows": 5,
    },
    "negative_delta": {
        "generation": 1, "drift_triggers": 7, "shadow_auc_delta": -0.25,
        "promotions": {"rejected": 7}, "reservoir_rows": None,
        "breaker_open": True, "breaker_trips": 1,
    },
}
_BLOCK = "# TYPE mlops_tpu_bundle_generation gauge"


def _ring():
    return RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8)


def _block(text: str) -> list[str]:
    """The lifecycle block: the last series of both renders."""
    lines = text.splitlines()
    return lines[lines.index(_BLOCK):] if _BLOCK in lines else []


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_the_ring_lifecycle_row_renders_as_the_jax_ring_render(name):
    ring, jax_ring = _ring(), JaxRing(workers=1, slots_small=2, slots_large=1, large_rows=8)
    try:
        assert _block(render_ring_metrics(ring)) == []
        ring.write_lifecycle(SNAPSHOTS[name])
        jax_ring.write_lifecycle(SNAPSHOTS[name])
        got = _block(render_ring_metrics(ring))
        assert got and got == _block(jax_render_ring_metrics(jax_ring))
    finally:
        ring.close()
        jax_ring.close()


class _Controller:
    """A controller's gauge surface: what ``metrics_snapshot`` returns."""

    def __init__(self, **snapshot):
        self.snapshot = snapshot

    def metrics_snapshot(self):
        return dict(self.snapshot)


def _series(text: str) -> dict[str, float]:
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in _block(text) if not line.startswith("#")}


def test_a_reattached_engine_carries_the_lifecycle_counters_as_bases():
    ring = _ring()
    try:
        first = RingService(object(), ring, monitor_fetch_every_s=0)
        first.reattach()
        first.lifecycle = _Controller(
            generation=2, drift_triggers=3, shadow_auc_delta=0.05,
            promotions={"promoted": 1, "rejected": 2, "rolled_back": 0},
            reservoir_rows=900, breaker_open=True, breaker_trips=1)
        first._write_lifecycle()  # the dead incarnation's last tick
        before = _series(render_ring_metrics(ring))
        second = RingService(object(), ring, monitor_fetch_every_s=0)
        second.reattach()
        second.lifecycle = _Controller(
            generation=1, drift_triggers=1, shadow_auc_delta=None,
            promotions={"promoted": 0, "rejected": 1, "rolled_back": 0},
            reservoir_rows=120, breaker_open=False, breaker_trips=0)
        second._write_lifecycle()
        after = _series(render_ring_metrics(ring))
        t = 'tenant="default"'
        for name in (f"mlops_tpu_drift_trigger_total{{{t}}}",
                     f"mlops_tpu_lifecycle_breaker_trips_total{{{t}}}",
                     *(f'mlops_tpu_promotions_total{{{t},outcome="{o}"}}'
                       for o in ("promoted", "rejected", "rolled_back"))):
            assert after[name] >= before[name], name
        assert after[f"mlops_tpu_drift_trigger_total{{{t}}}"] == 4
        assert after[f'mlops_tpu_promotions_total{{{t},outcome="rejected"}}'] == 3
        # Gauges are the live controller's: the fork-time bundle again.
        assert after[f"mlops_tpu_bundle_generation{{{t}}}"] == 1
        assert after[f"mlops_tpu_lifecycle_breaker_open{{{t}}}"] == 0
        assert f"mlops_tpu_shadow_auc_delta{{{t}}}" not in after
        # A third incarnation stacks on the second's published totals.
        third = RingService(object(), ring, monitor_fetch_every_s=0)
        third.reattach()
        third.lifecycle = _Controller(generation=1, drift_triggers=0,
                                      promotions={}, breaker_trips=0)
        third._write_lifecycle()
        assert _series(render_ring_metrics(ring))[
            f"mlops_tpu_drift_trigger_total{{{t}}}"] == 4
    finally:
        ring.close()


def test_the_telemetry_thread_mirrors_an_attached_controller(scenery):
    ring = _ring()
    engine = InferenceEngine(scenery["bundle"], buckets=(1, 8), device="cpu")
    service = RingService(engine, ring, monitor_fetch_every_s=0)
    try:
        service.reattach()
        service.start()
        assert service._telemetry is None  # no monitor cadence, no controller
        controller = _Controller(generation=1, drift_triggers=0, promotions={})
        service.attach_lifecycle(controller)
        assert service._telemetry is not None and ring.life_vals[0, LIFE_HAS]
        controller.snapshot["drift_triggers"] = 5
        deadline = time.monotonic() + 10
        while 'mlops_tpu_drift_trigger_total{tenant="default"} 5' not in render_ring_metrics(ring):
            assert time.monotonic() < deadline, "the telemetry thread never ticked"
            time.sleep(0.05)
    finally:
        service.stop()
        ring.close()


def test_a_job_routed_before_a_promotion_counts_under_the_tier_that_served(scenery, tmp_path):
    """The ring resolves a slot's tier when it groups the job; the engine
    resolves it again under its lock. A quant-routed job that meets the
    candidate's generation (no quant tier) serves, and counts, on the
    default tier."""
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig

    bundle = scenery["bundle"]
    with_quant = tmp_path / "with_quant"
    save_exact_bundle(with_quant, ModelConfig(family="mlp", hidden_dims=(32, 32), embed_dim=4),
                      bundle.model, bundle.preprocessor, bundle.monitor,
                      calibration={"temperature": 1.0},
                      quant_params=quantize_student(init_quant_master(0)),
                      quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}})
    live = InferenceEngine(load_bundle(with_quant), buckets=(1, 8), device="cpu",
                           tier_routing=True)
    candidate = InferenceEngine(bundle, buckets=(1, 8), device="cpu", tier_routing=True)
    for engine in (live, candidate):
        engine.warmup()
    assert live.available_tiers == ("quant", "exact")
    live.swap_bundle(candidate)
    live.route_tier = lambda slo: "quant"  # routed before the swap
    cat, num = scenery["normal"].cat_ids[:3], scenery["normal"].numeric[:3]

    async def scenario(ring):
        client = RingClient(ring, 0)
        service = RingService(live, ring, monitor_fetch_every_s=0)
        service.reattach()
        service.start()
        try:
            slot = client.claim(3, 1)
            future = client.submit(slot, cat, num)
            while not future.done():
                client.on_doorbell()
                await asyncio.sleep(0.01)
            client.release(slot)
        finally:
            service.stop()

    ring = _ring()
    try:
        asyncio.run(scenario(ring))
        text = render_ring_metrics(ring)
        assert 'mlops_tpu_tier_requests_total{tier="exact"} 1' in text
        assert 'mlops_tpu_tier_requests_total{tier="quant"} 0' in text
        assert live.dispatch_counts() == {"bucket_8": 1}
    finally:
        ring.close()


# ------------------------------------------------- the decisions, in process
async def _ring_feed(client, ds, batch: int = 8) -> None:
    """``feed`` through the ring: ``batch``-row requests one at a time, so
    the engine dispatches what ``feed`` dispatches."""
    for lo in range(0, ds.cat_ids.shape[0], batch):
        slot = client.claim(min(batch, ds.cat_ids.shape[0] - lo))
        future = client.submit(slot, ds.cat_ids[lo:lo + batch], ds.numeric[lo:lo + batch])
        while not future.done():
            client.on_doorbell()
            await asyncio.sleep(0.002)
        client.release(slot)


class _RingFeeder:
    """``feed(engine, ds)`` for ``_drive``, through an in-process ring
    whose service holds the controller engine-side."""

    def __init__(self, client, loop):
        self.client, self.loop = client, loop

    def __call__(self, engine, ds):
        self.loop.run_until_complete(_ring_feed(self.client, ds))


@pytest.fixture(scope="module")
def jax_engine(scenery):
    engine = JaxEngine(jax_load_bundle(scenery["bundle_dir"]), buckets=(1, 8),
                       enable_grouping=False)
    engine.warmup()
    return engine


def test_the_engine_side_controller_makes_the_jax_decisions(scenery, jax_engine, monkeypatch):
    import test_torch_lifecycle_loop as loop_module

    clock = {"t": 0.0}
    engine = InferenceEngine(scenery["bundle"], buckets=(1, 8), device="cpu")
    engine.warmup()
    ctrl = LifecycleController(
        engine, _no_latency_gate(port_config(scenery["td"] / "ring", scenery["labeled"])),
        clock=lambda: clock["t"], force_incumbent_preprocessor=True)
    ring = RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8)
    service = RingService(engine, ring, monitor_fetch_every_s=0)
    loop = asyncio.new_event_loop()
    try:
        service.reattach()
        service.start()
        service.attach_lifecycle(ctrl)
        monkeypatch.setattr(loop_module, "feed", _RingFeeder(RingClient(ring, 0), loop))
        got, status = _drive(ctrl, engine, scenery["normal"], scenery["drifted"], clock)
        ctrl.stop()
        service._write_lifecycle()
        text = render_ring_metrics(ring)
    finally:
        service.stop()
        loop.close()
        ring.close()
    monkeypatch.undo()

    jclock = {"t": 0.0}
    jctrl = JaxController(
        jax_engine, _no_latency_gate(jax_config(scenery["td"] / "jax", scenery["labeled"])),
        clock=lambda: jclock["t"], force_incumbent_preprocessor=True)
    jnormal, jdrifted = traffic(jax_engine.bundle.preprocessor)
    want, _ = _drive(jctrl, jax_engine, jnormal, jdrifted, jclock)
    jctrl.stop()
    assert got == want
    assert got[-1][1:] == (1, {"promoted": 1, "rejected": 0, "rolled_back": 0}, 2)
    assert status["generation"] == 2
    assert 'mlops_tpu_bundle_generation{tenant="default"} 2' in text
    assert 'mlops_tpu_promotions_total{tenant="default",outcome="promoted"} 1' in text


def _breaker_drive(ctrl, engine, normal, drifted, clock, feed_fn):
    feed_fn(engine, normal)
    steps = [ctrl.run_once()]
    for _ in range(4):
        feed_fn(engine, drifted)
        clock["t"] += 1.0
        steps.append(ctrl.run_once())
    return [(s["state"], s["drift_triggers"], s["breaker_open"], s["breaker_trips"],
             s["last_error"]) for s in steps]


def test_injected_retrain_failures_open_the_breaker_as_in_jax(scenery):
    # A JAX engine of its own: the shared one may have promoted already.
    jax_engine = JaxEngine(jax_load_bundle(scenery["bundle_dir"]), buckets=(1, 8),
                           enable_grouping=False)
    rules = [{"point": "lifecycle.retrain", "mode": "raise",
              "message": "injected retrain failure"}]
    runs = []
    for module, config_fn, engine, (normal, drifted) in (
        (faults, port_config, InferenceEngine(scenery["bundle"], buckets=(1, 8), device="cpu"),
         (scenery["normal"], scenery["drifted"])),
        (jax_faults, jax_config, jax_engine, traffic(jax_engine.bundle.preprocessor)),
    ):
        config = config_fn(scenery["td"] / f"breaker-{module.__name__}", scenery["labeled"])
        lc = config.lifecycle
        lc.hysteresis_windows, lc.breaker_failures, lc.breaker_cooldown_s = 1, 2, 100.0
        clock = {"t": 0.0}
        ctrl = (LifecycleController if module is faults else JaxController)(
            engine, config, clock=lambda: clock["t"])
        plan = module.arm(module.FaultPlan.from_rules(rules))
        try:
            runs.append(_breaker_drive(ctrl, engine, normal, drifted, clock, feed))
        finally:
            module.disarm()
            ctrl.stop()
        runs[-1].append(plan.trace())
    assert runs[0] == runs[1]
    assert runs[0][2][1:4] == (2, True, 1)
    assert runs[0][-1] == [("lifecycle.retrain", 0, "lifecycle.retrain", "raise"),
                           ("lifecycle.retrain", 1, "lifecycle.retrain", "raise")]


# -------------------------------------------------------- the plane, end to end
PLAN = """\
seed = 7
[[fault]]
point = "lifecycle.retrain"
mode = "raise"
max_fires = 2
message = "injected retrain failure"
"""


def _lifecycle(text: str) -> dict[str, float]:
    return {re.sub(r'\{tenant="default",?', "{", k): v for k, v in _series(text).items()}


def _scrapes_by_worker(text: str) -> dict[str, float]:
    """Each front end's count of answered ``/metrics`` requests."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'mlops_tpu_requests_total\{route="/metrics",status="200",worker="(\d)",'
        r'tenant="default"\} (\S+)', text)}


def test_the_ring_plane_runs_the_loop_under_a_fault_plan(scenery, tmp_path):
    plan = tmp_path / "chaos.toml"
    plan.write_text(PLAN)
    plane = Plane(
        scenery["bundle_dir"], tmp_path / "plane.log",
        config=ROOT / "configs/lifecycle_serve.toml",
        env={"MLOPS_TPU_FAULTS": str(plan), "MLOPS_TPU_SERVE_WORKERS": "2"},
        overrides=("serve.warmup_batch_sizes=1,8", "serve.max_batch=8",
                   "serve.monitor_fetch_every_s=0.5", f"lifecycle.dir={tmp_path / 'state'}",
                   f"lifecycle.labeled_path={scenery['labeled']}",
                   "lifecycle.retrain_steps=50", "lifecycle.min_labeled_rows=500",
                   "lifecycle.min_window_rows=32", "lifecycle.cooldown_s=1",
                   "lifecycle.tick_s=0.25", "lifecycle.mirror_fraction=1.0",
                   "lifecycle.shadow_min_mirrors=4", "lifecycle.max_ece=0.3",
                   "lifecycle.max_p99_ratio=1000", "lifecycle.breaker_failures=2",
                   "lifecycle.breaker_cooldown_s=4"))
    normal = json.dumps(records(8, seed=11)).encode()
    drifted = json.dumps(records(8, seed=12, drift=3.0)).encode()
    phase, stop, statuses, sent = {"drift": False}, threading.Event(), [], [0]

    def hammer():
        while not stop.is_set():
            status = exchange(plane.port, "POST", "/predict",
                              drifted if phase["drift"] else normal)[0]
            statuses.append(status)
            sent[0] += 8

    def scrape():
        return exchange(plane.port, "GET", "/metrics")[2].decode()

    def wait_for(key, minimum, seconds, seen=None):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            assert plane.proc.poll() is None, plane.text()[-3000:]
            values = _lifecycle(scrape())
            if seen is not None:
                seen.append(values)
            if values.get(key, -1) >= minimum:
                return values
            time.sleep(0.1)
        raise AssertionError(f"{key} never reached {minimum}: {plane.text()[-3000:]}")

    clients = [threading.Thread(target=hammer) for _ in range(2)]
    try:
        deadline = time.monotonic() + 30
        while "lifecycle controller started" not in plane.text():
            assert time.monotonic() < deadline, plane.text()[-3000:]
            time.sleep(0.05)
        first = _lifecycle(scrape())
        assert first["mlops_tpu_bundle_generation{}"] == 1
        for client in clients:
            client.start()
        time.sleep(1.0)
        phase["drift"] = True
        seen: list[dict] = []
        opened = wait_for("mlops_tpu_lifecycle_breaker_open{}", 1, 30, seen)
        assert opened["mlops_tpu_lifecycle_breaker_trips_total{}"] == 1
        assert opened["mlops_tpu_drift_trigger_total{}"] == 2
        promoted = wait_for('mlops_tpu_promotions_total{outcome="promoted"}', 1, 60, seen)
        assert promoted["mlops_tpu_bundle_generation{}"] == 2
        assert promoted["mlops_tpu_lifecycle_breaker_open{}"] == 0
        stop.set()
        for client in clients:
            client.join(timeout=30)
        assert statuses and set(statuses) == {200}
        # Counters never go back across scrapes of either front end.
        for key in ("mlops_tpu_drift_trigger_total{}",
                    "mlops_tpu_lifecycle_breaker_trips_total{}"):
            values = [s[key] for s in seen if key in s]
            assert values == sorted(values), key
        # Every front end renders the same block at generation 2: scrapes
        # on new connections until both have answered some.
        start = _scrapes_by_worker(scrape())
        blocks = []
        for _ in range(80):
            text = scrape()
            blocks.append(_block(text))
            counts = _scrapes_by_worker(text)
            if all(counts.get(w, 0) > start.get(w, 0) + 1 for w in "01"):
                break
        assert all(counts.get(w, 0) > start.get(w, 0) + 1 for w in "01"), counts
        assert all(block == blocks[0] for block in blocks)
        assert 'mlops_tpu_bundle_generation{tenant="default"} 2' in blocks[0]
        # kill -9 after the promotion: the respawn serves the fork-time
        # bundle at generation 1 and no counter goes back.
        before = _lifecycle(scrape())
        rows = plane.metric("mlops_tpu_rows_scored_total")
        incarnation = plane.metric("mlops_tpu_engine_incarnation")
        os.kill(plane.pids()["engine"], signal.SIGKILL)
        deadline = time.monotonic() + 60
        while True:
            try:
                if (plane.metric("mlops_tpu_engine_incarnation") > incarnation
                        and exchange(plane.port, "GET", "/healthz/ready")[0] == 200):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, plane.text()[-3000:]
            time.sleep(0.1)
        deadline = time.monotonic() + 10
        while (after := _lifecycle(scrape()))["mlops_tpu_bundle_generation{}"] != 1:
            assert time.monotonic() < deadline, after
            time.sleep(0.1)
        assert plane.metric("mlops_tpu_rows_scored_total") >= rows
        for key, value in before.items():
            if "_total" in key:
                assert after[key] >= value, key
        assert after['mlops_tpu_promotions_total{outcome="promoted"}'] == 1
        assert exchange(plane.port, "POST", "/predict", normal)[0] == 200
        assert plane.stop() == 0
        log = plane.text()
        assert log.count("injected retrain failure") >= 2
        for worker in (0, 1):
            assert re.search(rf"frontend {worker} \(pid \d+\) exited 0", log)
        assert re.search(r"engine replica 0 \(pid \d+\) exited 0", log)
    finally:
        stop.set()
        plane.stop()
