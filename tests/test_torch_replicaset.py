"""The engine replica set (``replicaset/``, the ring's replica axis,
``serve --replicas E``) against the JAX package, on the CPU:

- the router's choices against the JAX ``ReplicaRouter`` on the same
  gauge states: ties, skewed small-class affinity, a dead replica, a full
  outage, the large class;
- ``ServeConfig.validate``'s replica messages, the lifecycle refusal of
  a replica fleet and ``serve --replicas`` against the JAX package's;
- the per-replica ``/metrics`` block byte for byte against the JAX ring
  render of the same rows;
- a replica's re-attach replaying only the busy slots routed to it;
- E = 2 answers bitwise equal to E = 1 on the port's CPU engines;
- a two-replica plane in a subprocess (``serve.workers=2
  serve.engine_replicas=2``): a burst against the JAX engine's answers,
  then a ``kill -9`` of replica 1 under traffic with no non-200 answer,
  replica 0's incarnation unchanged and replica 1's up by one.
"""

import argparse
import asyncio
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import build_parser as jax_build_parser
from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.config import ServeConfigError as JaxServeConfigError
from mlops_tpu.replicaset import ReplicaRouter as JaxReplicaRouter
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.frontend import serve_multi_worker as jax_serve_multi_worker
from mlops_tpu.serve.ipc import RequestRing as JaxRing
from mlops_tpu.serve.metrics import render_ring_metrics as jax_render_ring_metrics
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import build_parser
from mlops_tpu_torch.config import ServeConfig, ServeConfigError, load_config
from mlops_tpu_torch.replicaset import ReplicaRouter
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.frontend import serve_multi_worker
from mlops_tpu_torch.serve.ipc import RequestRing, RingClient, RingService
from mlops_tpu_torch.serve.metrics import (
    ENG_INCARNATION,
    ENG_REPLAYED,
    ENG_RESPAWNS,
    MON_HAS,
    MON_ROWS,
    render_ring_metrics,
)
from torch_ring import Plane, budget, exchange, make_bundle, records  # noqa: F401

EXACT_PRED_ATOL = 1.6e-2 + 1e-6  # test_torch_frontend.py's tolerances
QUANT_PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5 + 1e-6


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("replicaset"))


# ------------------------------------------------------------------ router
class _Gauges:
    """The ring fields a router reads: replicas, readiness, live depth."""

    def __init__(self, workers: int, replicas: int) -> None:
        self.replicas = replicas
        self.rep_ready = np.ones(replicas, np.uint64)
        self.rep_inflight = np.zeros((workers, replicas), np.uint64)


# Each case: (workers, replicas, slack, steps); a step is (tenant, class,
# depth changes {(worker, replica): +n}, readiness changes {replica: 0|1})
# applied before the route.
ROUTER_CASES = {
    "ties break low, then spread": (2, 3, 4, [
        (0, 1, {}, {}), (0, 1, {(0, 0): 1}, {}), (0, 1, {(1, 1): 1}, {}),
        (1, 1, {(0, 2): 1}, {}), (0, 1, {(0, 0): 1}, {}),
    ]),
    "small class sticks within the slack": (2, 2, 2, [
        (0, 0, {}, {}), (0, 0, {(0, 0): 2}, {}), (0, 0, {(1, 0): 1}, {}),
        (1, 0, {}, {}), (1, 0, {(0, 1): 4}, {}), (0, 0, {(1, 0): 3}, {}),
        (0, 0, {}, {}),
    ]),
    "a dead replica is routed around": (1, 3, 4, [
        (0, 0, {}, {}), (0, 0, {}, {0: 0}), (2, 1, {(0, 1): 3}, {}),
        (0, 0, {(0, 2): 1}, {1: 0}), (1, 0, {}, {0: 1}), (0, 1, {}, {}),
    ]),
    "no replica ready parks on the least loaded": (2, 2, 4, [
        (0, 1, {(0, 0): 2}, {0: 0, 1: 0}), (0, 0, {}, {}),
        (1, 0, {(1, 1): 5}, {}), (0, 1, {}, {1: 1}),
    ]),
    "one replica is always replica 0": (2, 1, 4, [
        (0, 0, {}, {}), (1, 1, {(0, 0): 3}, {}), (0, 0, {}, {0: 0}),
    ]),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_the_router_chooses_as_jax_on_the_same_gauges(case):
    workers, replicas, slack, steps = ROUTER_CASES[case]
    gauges = _Gauges(workers, replicas)
    port, jax = ReplicaRouter(gauges, slack), JaxReplicaRouter(gauges, slack)
    got, want = [], []
    for tenant, cls, depth, ready in steps:
        for (w, r), n in depth.items():
            gauges.rep_inflight[w, r] += n
        for r, flag in ready.items():
            gauges.rep_ready[r] = flag
        got.append(port.route(tenant, cls))
        want.append(jax.route(tenant, cls))
        assert port.candidates() == jax.candidates()
        assert [port.depth(r) for r in range(replicas)] == [
            jax.depth(r) for r in range(replicas)]
    assert got == want


# ----------------------------------------------------------- config, CLI
@pytest.mark.parametrize("fields", [
    {"engine_replicas": 0, "workers": 2},
    {"engine_replicas": 2, "workers": 0},
    {"engine_replicas": 3, "workers": 1, "replica_affinity_slack": -1},
    {"replica_affinity_slack": -2, "workers": 2},
])
def test_the_replica_validation_messages_are_jax(fields):
    with pytest.raises(ServeConfigError) as got:
        ServeConfig(**fields).validate()
    with pytest.raises(JaxServeConfigError) as want:
        JaxServeConfig(**fields).validate()
    assert str(got.value) == str(want.value)


def test_a_replica_fleet_with_the_lifecycle_loop_is_refused_as_in_jax(tmp_path):
    """The supervisor refuses before it builds anything, with JAX's text."""
    overrides = ["serve.workers=2", "serve.engine_replicas=2", "lifecycle.enabled=true"]
    config = load_config(overrides, env={})
    jax_config = JaxConfig()
    jax_config.serve.workers, jax_config.serve.engine_replicas = 2, 2
    jax_config.lifecycle.enabled = True
    with pytest.raises(SystemExit) as got:
        serve_multi_worker(config, str(tmp_path))
    with pytest.raises(SystemExit) as want:
        jax_serve_multi_worker(jax_config, str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "incompatible with lifecycle.enabled" in str(got.value)


@pytest.mark.parametrize("argv", [
    ["serve", "--workers", "2", "--replicas", "3"],
    ["serve", "--replicas", "2", "serve.workers=4", "serve.replica_affinity_slack=1"],
    ["serve", "serve.engine_replicas=2", "--replicas", "4", "--workers", "2"],
])
def test_serve_replicas_maps_to_the_config_as_in_jax(argv, monkeypatch):
    seen = {}
    monkeypatch.setattr("mlops_tpu_torch.cli._serve",
                        lambda config: seen.setdefault("config", config) and 0)
    from mlops_tpu_torch.cli import main

    main(argv)
    port = seen["config"].serve
    args = jax_build_parser().parse_args(argv)
    jax = load_jax_config(args)
    assert isinstance(build_parser().parse_args(argv), argparse.Namespace)
    for key in ("workers", "engine_replicas", "replica_affinity_slack"):
        assert getattr(port, key) == getattr(jax.serve, key), key


def load_jax_config(args):
    """The JAX CLI's config from parsed args: its loader, then the flag
    sugar ``commands.run`` applies."""
    from mlops_tpu.config import load_config as jax_load_config

    config = jax_load_config(args.config, overrides=list(args.overrides), env={})
    if getattr(args, "workers", None) is not None:
        config.serve.workers = args.workers
    if getattr(args, "tenants", None):
        config.serve.tenants_path = args.tenants
    if getattr(args, "replicas", None) is not None:
        config.serve.engine_replicas = args.replicas
    return config


# ----------------------------------------------------------------- render
def _block(text: str, prefix: str = "mlops_tpu_replica_") -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith(prefix) or line.startswith(f"# TYPE {prefix}")]


@pytest.mark.parametrize("replicas,tenants", [(1, 1), (2, 1), (3, 2)])
def test_the_per_replica_block_renders_as_the_jax_ring_render(replicas, tenants):
    names = tuple(f"t{i}" for i in range(tenants))
    kw = dict(workers=2, slots_small=2, slots_large=1, large_rows=8,
              tenant_names=names, replicas=replicas)
    ring, jax_ring = RequestRing(**kw), JaxRing(**kw)
    try:
        assert _block(render_ring_metrics(ring)) == _block(jax_render_ring_metrics(jax_ring))
        rng = np.random.default_rng(replicas * 10 + tenants)
        for r in range(replicas):
            ready = int(rng.integers(0, 2))
            depth = rng.integers(0, 5, 2)
            incarnation, respawns, replayed = (int(x) for x in rng.integers(1, 9, 3))
            for target in (ring, jax_ring):
                target.rep_ready[r] = ready
                target.rep_inflight[:, r] = depth
                target.eng_vals[r, ENG_INCARNATION] = incarnation
                target.eng_vals[r, ENG_RESPAWNS] = respawns
                target.eng_vals[r, ENG_REPLAYED] = replayed
                for t in range(tenants):
                    target.mon_vals[r, t, MON_ROWS] = 100 * r + 7 * t + 3
                    target.mon_vals[r, t, MON_HAS] = 1.0
        got = _block(render_ring_metrics(ring))
        assert len(got) == 6 * (replicas + 1)
        assert got == _block(jax_render_ring_metrics(jax_ring))
        rows = "mlops_tpu_rows_scored_total"
        assert _block(render_ring_metrics(ring), rows) == _block(
            jax_render_ring_metrics(jax_ring), rows)
    finally:
        ring.close()
        jax_ring.close()


# --------------------------------------------------------------- reattach
class _Recorder:
    """A grouping-free engine that records the slots' first rows."""

    supports_grouping = False
    default_tier = "exact"

    def __init__(self) -> None:
        self.seen: list[float] = []

    def dispatch_arrays(self, cat, num, tier=None):
        self.seen.append(float(num[0, 0]))
        return cat.shape[0]

    def fetch_arrays_raw(self, n):
        return np.full(n, 0.5), np.zeros(n), np.zeros(23)

    def dispatch_counts(self):
        return {}


def test_a_replica_reattach_replays_only_its_own_slots():
    """Busy slots routed to replicas 0 and 1 (slot 5's descriptor still
    queued for replica 1): replica 1's re-attach replays its own unqueued
    slots alone, onto its own completion queues, and bumps its own
    incarnation; replica 0's then replays the rest."""
    ring = RequestRing(workers=2, slots_small=2, slots_large=1, large_rows=8, replicas=2)
    try:
        routed = {0: 0, 1: 1, 2: 1, 4: 0, 5: 1}  # slot -> replica
        for slot, replica in routed.items():
            cat, num = ring.request_views(slot)
            num[0, 0] = float(slot)
            ring.slot_n[slot] = 1
            ring.slot_replica[slot] = replica
            ring.slot_busy[slot] = 1
        ring.submit(5, int(ring.slot_gen[5]), replica=1)
        engine = _Recorder()
        service = RingService(engine, ring, replica=1)
        stats = service.reattach()
        assert stats["incarnation"] == 1 and stats["replayed_slots"] == 2
        assert engine.seen == [1.0, 2.0]
        assert int(ring.eng_vals[1, ENG_INCARNATION]) == 1
        assert int(ring.eng_vals[0, ENG_INCARNATION]) == 0
        # Slot 1 belongs to worker 0, slot 2 to worker 1: each completion
        # lands on replica 1's queue of its owner.
        assert ring.pop_completions(0, replica=1) == [(1, int(ring.slot_gen[1]))]
        assert ring.pop_completions(1, replica=1) == [(2, int(ring.slot_gen[2]))]
        assert ring.pop_completions(0, replica=0) == ring.pop_completions(1, replica=0) == []
        lead = RingService(_Recorder(), ring, replica=0)
        assert lead.reattach()["replayed_slots"] == 2
        assert lead.engines[0].seen == [0.0, 4.0]
        assert int(ring.eng_vals[1, ENG_REPLAYED]) == int(ring.eng_vals[0, ENG_REPLAYED]) == 2
        lead._pool.shutdown()
        service._pool.shutdown()
    finally:
        ring.close()


def test_two_replicas_answer_bitwise_as_one(bundle_dir):
    """The same requests through a one-replica ring and, alternating,
    through both replicas of a two-replica ring (each with its own CPU
    engine over the bundle): every answer is the same bits."""
    bundle = load_bundle(bundle_dir)
    bodies = [records(n, seed=40 + n, drift=0.2) for n in (1, 3, 8, 1, 5, 2)]
    encoded = [bundle.preprocessor.encode(records_to_columns(r)) for r in bodies]

    def engine():
        e = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu")
        e.warmup()
        return e

    async def serve(replicas):
        ring = RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8,
                           replicas=replicas)
        services = [RingService(engine(), ring, max_inflight=2, threads=2,
                                monitor_fetch_every_s=0, replica=r)
                    for r in range(replicas)]
        try:
            client = RingClient(ring, 0)
            loop = asyncio.get_running_loop()
            for r, service in enumerate(services):
                service.reattach()
                service.start()
                ring.set_ready(True, r)
                loop.add_reader(ring.worker_doorbell(0, r).fileno(), client.on_doorbell, r)
            out = []
            for i, ds in enumerate(encoded):
                slot = client.claim(len(ds.cat_ids))
                future = client.submit(slot, ds.cat_ids, ds.numeric, replica=i % replicas)
                assert await asyncio.wait_for(future, 30) == 0
                out.append(tuple(np.array(a) for a in client.response_arrays(slot)))
                client.release(slot)
        finally:
            for r in range(replicas):
                loop.remove_reader(ring.worker_doorbell(0, r).fileno())
            for service in services:
                service.stop()  # writes each replica's final aggregate
        return out, [int(ring.mon_vals[r, 0, MON_ROWS]) for r in range(replicas)], ring

    one, _, ring1 = asyncio.run(serve(1))
    two, rows, ring2 = asyncio.run(serve(2))
    try:
        for a, b in zip(one, two):
            for x, y in zip(a, b):
                assert x.tobytes() == y.tobytes()
        sizes = [len(r) for r in bodies]
        assert rows == [sum(sizes[0::2]), sum(sizes[1::2])]
        assert ring2.dispatch_counts() == ring1.dispatch_counts()
    finally:
        ring1.close()
        ring2.close()


# ------------------------------------------------------------------ plane
def _metrics(port) -> dict[str, float]:
    text = exchange(port, "GET", "/metrics")[2].decode()
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line and not line.startswith("#")}


def _burst(port, bodies, threads=8):
    out = [None] * len(bodies)
    work = iter(range(len(bodies)))
    lock = threading.Lock()

    def run():
        while True:
            with lock:
                i = next(work, None)
            if i is None:
                return
            body, headers = bodies[i]
            out[i] = exchange(port, "POST", "/predict", json.dumps(body).encode(), headers)

    pool = [threading.Thread(target=run) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=120)
    return out


def test_a_two_replica_plane_agrees_with_jax_and_survives_a_replica_kill(
        bundle_dir, tmp_path):
    # The plane boots while the JAX engine compiles the answers it is held
    # against.
    plane = Plane(bundle_dir, tmp_path / "replicas.log",
                  ("serve.workers=2", "serve.engine_replicas=2", "serve.tier_routing=true"),
                  wait=False)
    try:
        jax_engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64), tier_routing=True)
        rng = np.random.default_rng(5)
        pool = records(400, seed=5, drift=0.3)
        sizes = [1] * 48 + list(rng.integers(1, 9, size=32))
        bounds = np.cumsum([0, *sizes])
        bodies = [(pool[lo:hi], {"x-slo-class": "cheap"} if i % 4 == 0 else None)
                  for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]
        wants = [jax_engine.predict_records(recs, tier="quant" if headers else None)
                 for recs, headers in bodies]
        plane.wait_ready()
        deadline = time.monotonic() + 60
        while _metrics(plane.port).get('mlops_tpu_replica_ready{replica="1"}') != 1.0:
            assert time.monotonic() < deadline, "replica 1 never became ready"
            time.sleep(0.1)
        pids = plane.pids()
        assert pids["engine 0"] != pids["engine 1"]
        answers = _burst(plane.port, bodies)
        for (recs, headers), (status, _, body), want in zip(bodies, answers, wants):
            assert status == 200
            got, cheap = json.loads(body), headers is not None
            np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=0,
                                       atol=QUANT_PRED_ATOL if cheap else EXACT_PRED_ATOL)
            np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                                       list(want["feature_drift_batch"].values()),
                                       atol=DRIFT_ATOL, rtol=0)
        before = _metrics(plane.port)
        assert sum(before[f'mlops_tpu_replica_rows_scored_total{{replica="{r}"}}']
                   for r in (0, 1)) == before['mlops_tpu_rows_scored_total{tenant="default"}']
        # kill -9 of replica 1 under traffic: a brownout of half the
        # capacity, never a non-200 answer.
        result = {}
        stream = [(pool[i:i + 1], None) for i in range(120)]
        thread = threading.Thread(target=lambda: result.setdefault(
            "out", _burst(plane.port, stream, threads=6)))
        thread.start()
        time.sleep(0.2)
        os.kill(pids["engine 1"], signal.SIGKILL)
        thread.join(timeout=120)
        assert [a[0] for a in result["out"]] == [200] * len(stream)
        deadline = time.monotonic() + 60
        while True:
            after = _metrics(plane.port)
            if after['mlops_tpu_replica_ready{replica="1"}'] == 1.0 and (
                    after['mlops_tpu_replica_incarnation{replica="1"}'] == 2.0):
                break
            assert time.monotonic() < deadline, "replica 1 never came back"
            time.sleep(0.1)
        assert after['mlops_tpu_replica_incarnation{replica="0"}'] == 1.0
        assert after['mlops_tpu_replica_respawn_total{replica="1"}'] == 1.0
        assert after['mlops_tpu_replica_respawn_total{replica="0"}'] == 0.0
        assert after["mlops_tpu_engine_respawn_total"] == 1.0
        for name, value in before.items():
            if name.endswith("_total") or "_total{" in name:
                assert after.get(name, value) >= value, name
        ready = [json.loads(line.split("ready ", 1)[1]) for line in plane.text().splitlines()
                 if line.startswith("warmup complete; ready {")]
        assert sorted((r["replica"], r["incarnation"]) for r in ready) == [
            (0, 1), (1, 1), (1, 2)]
        assert plane.pids()["engine 0"] == pids["engine 0"]
    finally:
        assert plane.stop() == 0
    text = plane.text()
    for r in (0, 1):
        assert f"engine replica {r} (pid {plane.pids()[f'engine {r}']}) exited 0" in text
