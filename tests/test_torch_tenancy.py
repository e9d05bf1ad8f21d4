"""Tenancy (``tenancy/``, the ring's tenant axis, ``serve --tenants``)
against the JAX package, on the CPU:

- the tenants.toml loader and ``validate`` on the same files, with the
  same messages; ``TenantRouter``; ``QuotaGovernor`` decision traces on
  seeded acquire/release sequences; ``tenant_scoped_config``;
- the quota-shed 503 and the unknown-tenant 404 byte for byte, from the
  front ends of both packages;
- the per-tenant ``/metrics`` series and lifecycle blocks byte for byte
  against the JAX ring render of the same rows;
- a replica's replay dispatching each busy slot through its own tenant's
  engine;
- a three-tenant fleet (two mlp twins from two seeds and a linear model
  without a quant tier) on the single-process plane and on the ring plane
  with two replicas, each tenant's answers against its JAX engine with
  ``test_torch_frontend.py``'s tolerances and equal byte for byte across
  the planes, untagged requests on the default tenant, a ``kill -9`` of
  a replica under every tenant's traffic;
- a hot tenant at 10x the others' rate shedding against its own quota
  while the cold tenants never see a non-200 (stub engines);
- a drift on one tenant promoting it alone, the two tenants' ``run_once``
  sequences against the JAX controllers';
- ``--tenants`` and ``--replicas`` mapping to the config as in JAX.
"""

import asyncio
import json
import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import build_parser as jax_build_parser
from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.data.encode import Preprocessor as JaxPreprocessor
from mlops_tpu.lifecycle import LifecycleController as JaxController
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.frontend import FrontendServer as JaxFrontendServer
from mlops_tpu.serve.ipc import RequestRing as JaxRing
from mlops_tpu.serve.metrics import render_ring_metrics as jax_render_ring_metrics
from mlops_tpu.tenancy import QuotaGovernor as JaxQuotaGovernor
from mlops_tpu.tenancy import TenancyConfigError as JaxTenancyConfigError
from mlops_tpu.tenancy import TenantRouter as JaxTenantRouter
from mlops_tpu.tenancy import load_tenants_toml as jax_load_tenants_toml
from mlops_tpu.tenancy import tenant_scoped_config as jax_tenant_scoped_config
from mlops_tpu_torch.config import Config, ServeConfig
from mlops_tpu_torch.data.encode import Preprocessor
from mlops_tpu_torch.lifecycle.controller import LifecycleController
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.frontend import FrontendServer
from mlops_tpu_torch.serve.ipc import RequestRing, RingService
from mlops_tpu_torch.serve.metrics import (
    LIFE_OUTCOMES,
    MON_BATCHES,
    MON_FETCHED_AT,
    MON_FETCHES,
    MON_HAS,
    MON_OUTLIERS,
    MON_ROWS,
    render_ring_metrics,
)
from mlops_tpu_torch.tenancy import (
    QuotaGovernor,
    TenancyConfigError,
    TenantRouter,
    load_tenants_toml,
    tenant_scoped_config,
)
from test_torch_lifecycle_loop import _no_latency_gate
from test_torch_replicaset import _metrics, load_jax_config
from torch_lifecycle import feed, jax_config, port_config, scenery, traffic  # noqa: F401
from torch_ring import ROOT, Plane, budget, exchange, make_bundle, records  # noqa: F401

EXACT_PRED_ATOL = 1.6e-2 + 1e-6  # test_torch_frontend.py's tolerances
QUANT_PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5 + 1e-6
NAMES = ("emea", "apac", "latam-ab-arm")  # configs/tenants.toml's fleet
LINEAR = dict(family="linear", hidden_dims=(32, 32, 16), embed_dim=4, precision="bf16")


def _fleet_toml(path: Path, dirs: list) -> Path:
    """configs/tenants.toml (weights 2, 1, 1) with only its bundle
    directories replaced."""
    text = (ROOT / "configs" / "tenants.toml").read_text()
    for old, new in zip(("registry/credit-default/3", "registry/credit-default-apac/1",
                         "registry/credit-default-latam/2"), dirs):
        text = text.replace(f'"{old}"', json.dumps(str(new)))
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    for name in ("emea", "apac", "latam"):
        (root / name).mkdir()
    dirs = [make_bundle(root / "emea", seed=0), make_bundle(root / "apac", seed=1),
            make_bundle(root / "latam", seed=2, model=LINEAR, quant=False)]
    return {"dirs": dirs, "toml": _fleet_toml(root / "tenants.toml", dirs), "root": root}


# ------------------------------------------------------------ the loader
def _load_both(path):
    try:
        got = load_tenants_toml(path)
    except TenancyConfigError as err:
        got = ("error", str(err))
    try:
        want = jax_load_tenants_toml(path)
    except JaxTenancyConfigError as err:
        want = ("error", str(err))
    return got, want


def _specs(cfg):
    return [(s.name, s.bundle_dir, s.weight) for s in cfg.tenants], cfg.default_tenant


TOML_CASES = {
    "unknown top key": 'default-tenant = "a"\n[[tenant]]\nname = "a"\nbundle_dir = "x"\n',
    "tenant not an array": 'tenant = "a"\n',
    "entry not a table": 'tenant = [1, 2]\n',
    "unknown entry key": '[[tenant]]\nname = "a"\nbundle_dir = "x"\nweigth = 2\n',
    "weight not a number": '[[tenant]]\nname = "a"\nbundle_dir = "x"\nweight = "heavy"\n',
    "not toml": '[[tenant]\nname = "a"\n',
    "every problem at once": (
        'default_tenant = "zz"\n'
        '[[tenant]]\nname = "a b"\nbundle_dir = "x"\nweight = 0.0\n'
        '[[tenant]]\nname = "dup"\nbundle_dir = ""\n'
        '[[tenant]]\nname = "dup"\nbundle_dir = "/nonexistent/bundle"\nweight = -1\n'
        '[[tenant]]\nname = ""\nbundle_dir = "x"\n'
    ),
    "no tenant": 'default_tenant = ""\n',
    "a good fleet": (
        'default_tenant = "b"\n[[tenant]]\nname = "a"\nbundle_dir = "."\nweight = 3\n'
        '[[tenant]]\nname = "b"\nbundle_dir = "."\n'
    ),
}


@pytest.mark.parametrize("case", sorted(TOML_CASES) + ["missing file", "shipped file"])
def test_the_loader_and_validate_are_jax(case, tmp_path):
    if case == "shipped file":
        path = ROOT / "configs" / "tenants.toml"
    elif case == "missing file":
        path = tmp_path / "absent.toml"
    else:
        path = tmp_path / "tenants.toml"
        path.write_text(TOML_CASES[case])
    got, want = _load_both(path)
    if isinstance(want, tuple):
        assert got == want
        return
    assert _specs(got) == _specs(want)
    assert (got.names, got.weights) == (want.names, want.weights)
    for check in (True, False):
        try:
            got_ok = got.validate(check_bundles=check).default_index
        except TenancyConfigError as err:
            got_ok = str(err)
        try:
            want_ok = want.validate(check_bundles=check).default_index
        except JaxTenancyConfigError as err:
            want_ok = str(err)
        assert got_ok == want_ok, check
    if case == "shipped file":
        assert got.names == NAMES and got.weights == (2.0, 1.0, 1.0)
        assert got.default_index == 0


def test_the_router_resolves_labels_and_bills_as_jax():
    for names, default in ((NAMES, 0), (NAMES, 2), ((), 0), (("default",), 0)):
        port, jax = TenantRouter(names, default), JaxTenantRouter(names, default)
        assert port.names == jax.names
        for raw in ("", "emea", "apac", "latam-ab-arm", "default", "nope", "x" * 90):
            assert port.resolve(raw) == jax.resolve(raw), raw
            assert port.label(raw) == jax.label(raw), raw
            assert port.bill_label(raw) == jax.bill_label(raw), raw


@pytest.mark.parametrize("capacity,weights,seed", [
    (64, (2.0, 1.0, 1.0), 0), (4, (2.0, 1.0, 1.0), 1), (1, (1.0, 1.0), 2),
    (2, (1.0, 1.0), 3), (7, (5.0, 0.5, 1.5, 1.0), 4), (3, (1.0,), 5),
])
def test_the_quota_governor_decides_as_jax(capacity, weights, seed):
    port, jax = QuotaGovernor(capacity, weights), JaxQuotaGovernor(capacity, weights)
    assert port.floors == jax.floors
    rng = np.random.default_rng(seed)
    trace, jtrace = [], []
    for _ in range(400):
        tenant = int(rng.integers(0, len(weights)))
        # A hot tenant 0: most acquisitions are its.
        if rng.random() < 0.5:
            tenant = 0
        if rng.random() < 0.6:
            trace.append(port.try_acquire(tenant))
            jtrace.append(jax.try_acquire(tenant))
        else:
            port.release(tenant)
            jax.release(tenant)
            trace.append("release")
            jtrace.append("release")
        assert port.used == jax.used and port.total_used == jax.total_used
    assert trace == jtrace
    assert {"ok", "release"} <= set(trace)
    for bad in ((0, weights), (capacity, ()), (capacity, (1.0, 0.0))):
        with pytest.raises(ValueError) as got:
            QuotaGovernor(*bad)
        with pytest.raises(ValueError) as want:
            JaxQuotaGovernor(*bad)
        assert str(got.value) == str(want.value)


def test_tenant_scoped_config_is_jax():
    port, jax = Config(), JaxConfig()
    port.lifecycle.dir = jax.lifecycle.dir = "/var/lifecycle"
    for name in NAMES:
        got, want = tenant_scoped_config(port, name), jax_tenant_scoped_config(jax, name)
        assert got.lifecycle.dir == want.lifecycle.dir == f"/var/lifecycle/{name}"
        assert got.serve is port.serve and got.lifecycle is not port.lifecycle
        assert port.lifecycle.dir == "/var/lifecycle"


@pytest.mark.parametrize("argv", [
    ["serve", "--tenants", "configs/tenants.toml"],
    ["serve", "--tenants", "a.toml", "--workers", "2", "--replicas", "2"],
    ["serve", "serve.tenants_path=b.toml", "--tenants", "c.toml"],
])
def test_serve_tenants_maps_to_the_config_as_in_jax(argv, monkeypatch):
    seen = {}
    monkeypatch.setattr("mlops_tpu_torch.cli._serve",
                        lambda config: seen.setdefault("config", config) and 0)
    from mlops_tpu_torch.cli import main

    main(argv)
    jax = load_jax_config(jax_build_parser().parse_args(argv))
    for key in ("tenants_path", "workers", "engine_replicas"):
        assert getattr(seen["config"].serve, key) == getattr(jax.serve, key), key


# ------------------------------------------------- the front ends' answers
def _front_ends(fleet, slots_small=2):
    """Both packages' front end 0 over a three-tenant ring, in process
    (nothing forks; no engine: the answers below never reach one)."""
    tenancy = load_tenants_toml(fleet["toml"]).validate()
    jtenancy = jax_load_tenants_toml(fleet["toml"]).validate()
    kw = dict(workers=1, slots_small=slots_small, slots_large=1, large_rows=8,
              tenant_names=NAMES)
    ring, jring = RequestRing(**kw), JaxRing(**kw)
    preps = [str(Path(d) / "preprocess.npz") for d in fleet["dirs"]]
    port = FrontendServer(ServeConfig(), ring, 0, [Preprocessor.load(p) for p in preps],
                          tenancy)
    jax = JaxFrontendServer(JaxServeConfig(), jring, 0,
                            [JaxPreprocessor.load(p) for p in preps], tenancy=jtenancy)
    return port, jax, ring, jring


def _wire(answer) -> tuple:
    status, payload, *rest = answer
    body = json.dumps(payload, separators=(",", ":")).encode()
    return (status, body, *rest)


def test_the_quota_shed_and_the_unknown_tenant_answer_as_jax(fleet):
    port, jax, ring, jring = _front_ends(fleet)
    try:
        # Capacity 2, weights 2:1:1: emea's reserved floor is one slot, so
        # apac holds one and is refused a second against its own quota.
        for server in (port, jax):
            assert server.quota[0].try_acquire(1) == "ok"
        recs = records(1, seed=3)
        got = asyncio.run(port._score(recs, "rid", None, 0, tenant=1))
        want = asyncio.run(jax._score(recs, "rid", None, tenant=1))
        assert _wire(got) == _wire(want)
        assert got[0] == 503 and got[3] == {"retry-after": "1"}
        assert json.loads(_wire(got)[1]) == {"detail": "tenant 'apac' over quota; retry in 1s"}
        assert int(ring.quota_shed[0, 1]) == int(jring.quota_shed[0, 1]) == 1
        assert int(ring.shed.sum()) == int(jring.shed.sum()) == 0
        body = json.dumps(recs).encode()
        for raw in ("nope", "emea-but-longer" * 8, "<script>"):
            got = asyncio.run(port._predict(body, "rid", None, 0, raw))
            want = asyncio.run(jax._predict(body, "rid", None, None, raw, 0))
            assert _wire(got)[:2] == _wire(want)[:2]
            assert got[0] == 404
        # An unknown tenant is answered before validation, in both.
        got = asyncio.run(port._predict(b"[{", "rid", None, 0, "nope"))
        want = asyncio.run(jax._predict(b"[{", "rid", None, None, "nope", 0))
        assert _wire(got)[:2] == _wire(want)[:2]
    finally:
        jax._encode_pool.shutdown()
        ring.close()
        jring.close()


def test_the_per_tenant_series_render_as_the_jax_ring_render():
    kw = dict(workers=2, slots_small=2, slots_large=1, large_rows=8, tenant_names=NAMES,
              replicas=2)
    ring, jring = RequestRing(**kw), JaxRing(**kw)
    try:
        rng = np.random.default_rng(11)
        now = time.monotonic()
        for name in ("req_counts", "lat_counts", "lat_n", "inflight", "shed", "quota_shed"):
            values = rng.integers(0, 9, getattr(ring, name).shape)
            getattr(ring, name)[...] = values
            getattr(jring, name)[...] = values
        sums = rng.random(ring.lat_sum_ms.shape) * 100
        ring.lat_sum_ms[...] = jring.lat_sum_ms[...] = sums
        for r in range(2):
            for t in range(2):  # the third tenant has no monitor rows yet
                row = {MON_ROWS: 40 + r + t, MON_OUTLIERS: 3 + t, MON_BATCHES: 5 + r,
                       MON_FETCHES: 1 + t, MON_FETCHED_AT: now - r, MON_HAS: 1.0}
                last, total = rng.random(23), rng.random(23) * 7
                for target in (ring, jring):
                    for field, value in row.items():
                        target.mon_vals[r, t, field] = value
                    target.mon_drift_last[r, t] = last
                    target.mon_drift_sum[r, t] = total
        snapshots = {0: {"generation": 2, "drift_triggers": 3, "shadow_auc_delta": 0.25,
                         "promotions": {"promoted": 1}, "reservoir_rows": 9,
                         "breaker_open": False, "breaker_trips": 0},
                     2: {"generation": 1, "drift_triggers": 0, "shadow_auc_delta": None,
                         "promotions": {}, "reservoir_rows": 0, "breaker_open": True,
                         "breaker_trips": 2}}
        for t, snapshot in snapshots.items():
            ring.write_lifecycle(snapshot, t)
            jring.write_lifecycle(snapshot, t)
        text, jtext = render_ring_metrics(ring), jax_render_ring_metrics(jring)
        series = ("mlops_tpu_requests_total", "mlops_tpu_request_latency_ms",
                  "mlops_tpu_ring_depth", "mlops_tpu_shed_total",
                  "mlops_tpu_tenant_quota_shed_total", "mlops_tpu_rows_scored_total",
                  "mlops_tpu_outliers_total", "mlops_tpu_feature_drift_score",
                  "mlops_tpu_feature_drift_mean", "mlops_tpu_monitor_batches_total",
                  "mlops_tpu_replica_")
        for name in series:
            got = [ln for ln in text.splitlines() if name in ln]
            want = [ln for ln in jtext.splitlines() if name in ln]
            assert got and got == want, name
        block = "# TYPE mlops_tpu_bundle_generation gauge"
        got, want = text.splitlines(), jtext.splitlines()
        assert got[got.index(block):] == want[want.index(block):]
        assert sum('tenant="apac"' in ln for ln in got[got.index(block):]) == 0
        assert all(f'tenant="{n}"' in text for n in NAMES)
    finally:
        ring.close()
        jring.close()


class _Recorder:
    supports_grouping = True
    default_tier = "exact"

    def __init__(self, mark: float) -> None:
        self.mark, self.seen = mark, []

    def dispatch_arrays(self, cat, num, tier=None):
        self.seen.append(float(num[0, 0]))
        return cat.shape[0]

    def fetch_arrays_raw(self, n):
        return np.full(n, self.mark), np.zeros(n), np.zeros(23)

    def dispatch_group_arrays(self, parts, tier=None):
        self.seen += [float(num[0, 0]) for _, num in parts]
        return [len(cat) for cat, _ in parts]

    def fetch_group_raw(self, sizes):
        preds = np.full((len(sizes), 8), self.mark)
        return sizes, preds, np.zeros((len(sizes), 8)), np.zeros((len(sizes), 23))

    def dispatch_counts(self):
        return {}


def test_a_replay_lands_under_each_slots_tenant():
    ring = RequestRing(workers=1, slots_small=4, slots_large=1, large_rows=8,
                       tenant_names=NAMES[:2], replicas=2)
    try:
        tags = {0: (0, 1), 1: (1, 1), 2: (0, 1), 3: (1, 0), 4: (1, 1)}  # tenant, replica
        for slot, (tenant, replica) in tags.items():
            _, num = ring.request_views(slot)
            num[0, 0] = float(slot)
            ring.slot_n[slot] = 1
            ring.slot_tenant[slot] = tenant
            ring.slot_replica[slot] = replica
            ring.slot_busy[slot] = 1
        engines = [_Recorder(0.1), _Recorder(0.9)]
        service = RingService(engines[0], ring, engines=engines, replica=1)
        assert service.reattach()["replayed_slots"] == 4
        assert sorted(engines[0].seen) == [0.0, 2.0]
        assert sorted(engines[1].seen) == [1.0, 4.0]
        for slot in (0, 1, 2, 4):
            assert ring.response_views(slot)[0][0] == (0.1 if tags[slot][0] == 0 else 0.9)
        with pytest.raises(ValueError, match="2 tenant rows"):
            RingService(engines[0], ring)
        service._pool.shutdown()
    finally:
        ring.close()


# ------------------------------------------------------------ the planes
def _tenant_bodies():
    rng = np.random.default_rng(21)
    pool = records(300, seed=21, drift=0.3)
    sizes = [1, 3, 8, 1, 5, 2, 64]
    bounds = np.cumsum([0, *sizes])
    out = [pool[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    rng.shuffle(out)
    return out


def _check_tenant(got: dict, want: dict, cheap: bool) -> None:
    np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=0,
                               atol=QUANT_PRED_ATOL if cheap else EXACT_PRED_ATOL)
    np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                               list(want["feature_drift_batch"].values()),
                               atol=DRIFT_ATOL, rtol=0)


def _answers(port, bodies, tenant):
    out = []
    for i, recs in enumerate(bodies):
        headers = {"x-tenant": tenant} if tenant else {}
        if i % 3 == 0:
            headers["x-slo-class"] = "cheap"
        out.append(exchange(port, "POST", "/predict", json.dumps(recs).encode(), headers))
    return out


def _expected(fleet):
    jax = {}
    for name, path in zip(NAMES, fleet["dirs"]):
        bundle = jax_load_bundle(path)
        jax[name] = (JaxEngine(bundle, buckets=(1, 8, 64), tier_routing=True),
                     bundle.quant_params is not None)
    return jax


def test_a_tenant_fleet_answers_as_its_jax_engines_on_both_planes(fleet, tmp_path):
    # Both planes boot while the JAX engines compile the answers they are
    # held against; each plane is then driven in turn.
    planes = {plane_name: Plane(fleet["dirs"][0], tmp_path / f"{plane_name}.log",
                                (f"serve.tenants_path={fleet['toml']}",
                                 "serve.tier_routing=true", *overrides), wait=False)
              for plane_name, overrides in (
                  ("single", ("serve.workers=0",)),
                  ("ring", ("serve.workers=2", "serve.engine_replicas=2")))}
    try:
        jax = _expected(fleet)
        bodies = _tenant_bodies()
        wants = {}
        for name in NAMES:
            engine, has_quant = jax[name]
            for i, recs in enumerate(bodies):
                cheap = i % 3 == 0 and has_quant
                wants[name, i] = (engine.predict_records(recs, tier="quant" if cheap else None),
                                  cheap)
        for plane in planes.values():
            plane.wait_ready()
    except BaseException:
        for plane in planes.values():
            plane.stop()
        raise
    answers = {}
    try:
        _drive_both_planes(planes, bodies, wants, jax, answers)
    finally:
        for plane in planes.values():
            plane.stop()  # a no-op for a plane already stopped
    for name in NAMES:
        assert answers["ring", name] == answers["single", name], name
    # The twins from two seeds answer differently: the check above tells
    # the tenants apart.
    a, b = (json.loads(answers["single", n][1])["predictions"] for n in ("emea", "apac"))
    assert np.max(np.abs(np.subtract(a, b))) > 10 * EXACT_PRED_ATOL


def _drive_both_planes(planes, bodies, wants, jax, answers):
    for plane_name, plane in planes.items():
        try:
            for name in NAMES:
                got = _answers(plane.port, bodies, name)
                for i, (status, _, body) in enumerate(got):
                    assert status == 200, (plane_name, name)
                    want, cheap = wants[name, i]
                    _check_tenant(json.loads(body), want, cheap)
                answers[plane_name, name] = [a[2] for a in got]
            # Untagged traffic is the default tenant's (emea).
            untagged = [a[2] for a in _answers(plane.port, bodies, "")]
            assert untagged == answers[plane_name, "emea"]
            status, _, body = exchange(plane.port, "POST", "/predict", b"[{}]",
                                       {"x-tenant": "nope"})
            assert (status, json.loads(body)) == (404, {"detail": "unknown tenant 'nope'"})
            metrics = _metrics(plane.port)
            if plane_name == "ring":
                _kill_a_replica_under_every_tenant(plane, bodies, jax)
                workers = ("0", "1")
                label = 'mlops_tpu_requests_total{{route="/predict",status="{s}",worker="{w}",tenant="{t}"}}'
                for name in NAMES:
                    served = sum(metrics.get(label.format(s=200, w=w, t=name), 0) for w in workers)
                    want = len(bodies) * (2 if name == "emea" else 1)
                    assert served == want, name
                strangers = sum(metrics.get(label.format(s=404, w=w, t="emea"), 0)
                                for w in workers)
                assert strangers == 1  # billed to the default tenant
            else:
                for name in NAMES:
                    key = f'mlops_tpu_requests_total{{route="/predict",status="200",tenant="{name}"}}'
                    assert metrics[key] == len(bodies) * (2 if name == "emea" else 1)
        finally:
            assert plane.stop() == 0


def _kill_a_replica_under_every_tenant(plane, bodies, jax):
    """Every tenant's requests stream while replica 1 is killed: each
    answer is 200 and its own tenant's."""
    deadline = time.monotonic() + 60
    while _metrics(plane.port)['mlops_tpu_replica_ready{replica="1"}'] != 1.0:
        assert time.monotonic() < deadline, "replica 1 never became ready"
        time.sleep(0.1)
    incarnation = _metrics(plane.port)['mlops_tpu_replica_incarnation{replica="1"}']
    # Small requests only: a tenant's share of a worker's four large slabs
    # is one (weights 2:1:1), so concurrent large requests of one tenant
    # shed against its quota by design.
    small = [recs for recs in bodies if len(recs) <= 8]
    work = [(name, recs) for recs in small for name in NAMES] * 4
    out = [None] * len(work)
    order = iter(range(len(work)))
    lock = threading.Lock()

    def run():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            name, recs = work[i]
            out[i] = exchange(plane.port, "POST", "/predict", json.dumps(recs).encode(),
                              {"x-tenant": name})

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    os.kill(plane.pids()["engine 1"], signal.SIGKILL)
    for t in threads:
        t.join(timeout=120)
    for (name, recs), (status, _, body) in zip(work, out):
        assert status == 200, (name, body)
        _check_tenant(json.loads(body), jax[name][0].predict_records(recs), False)
    deadline = time.monotonic() + 60
    while _metrics(plane.port)['mlops_tpu_replica_incarnation{replica="1"}'] != incarnation + 1:
        assert time.monotonic() < deadline, "replica 1 never came back"
        time.sleep(0.1)


def test_a_hot_tenant_sheds_against_its_own_quota_and_the_cold_never(fleet, tmp_path):
    """Stub engines hold each slot 50 ms; apac streams on 20 connections
    (10x the others' two each) into 8 small slots a worker: apac's sheds
    are quota 503s with JAX's body, counted per tenant, and emea and
    latam-ab-arm see 200 only."""
    stub = tmp_path / "stub"
    dirs = []
    for name, src in zip(NAMES, fleet["dirs"]):
        d = stub / name
        d.mkdir(parents=True)
        (d / "preprocess.npz").write_bytes((Path(src) / "preprocess.npz").read_bytes())
        dirs.append(d)
    toml = _fleet_toml(tmp_path / "tenants.toml", dirs)
    plane = Plane(dirs[0], tmp_path / "stub.log",
                  (f"serve.tenants_path={toml}", "serve.workers=2",
                   "serve.ring_slots_small=8", "serve.ring_slots_large=2"),
                  stub=True, env={"STUB_DELAY_S": "0.05"})
    try:
        body = json.dumps(records(1, seed=4)).encode()
        results: dict[str, list] = {n: [] for n in NAMES}
        stop = time.monotonic() + 4.0

        def client(name):
            while time.monotonic() < stop:
                status, headers, payload = exchange(plane.port, "POST", "/predict", body,
                                                    {"x-tenant": name})
                results[name].append((status, headers.get("retry-after"), payload))

        clients = [("apac", 20), ("emea", 2), ("latam-ab-arm", 2)]
        threads = [threading.Thread(target=client, args=(n,)) for n, k in clients
                   for _ in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        hot = results["apac"]
        shed = [r for r in hot if r[0] == 503]
        assert shed
        assert {r[0] for r in hot} == {200, 503}
        assert all(r[1] == "1" and json.loads(r[2]) == {
            "detail": "tenant 'apac' over quota; retry in 1s"} for r in shed)
        for name in ("emea", "latam-ab-arm"):
            assert results[name] and {r[0] for r in results[name]} == {200}, name
        metrics = _metrics(plane.port)
        quota = {n: sum(metrics[f'mlops_tpu_tenant_quota_shed_total{{worker="{w}",tenant="{n}"}}']
                        for w in (0, 1)) for n in NAMES}
        assert quota == {"emea": 0, "apac": len(shed), "latam-ab-arm": 0}
        assert sum(v for k, v in metrics.items() if k.startswith("mlops_tpu_shed_total")) == 0
    finally:
        assert plane.stop() == 0


# ------------------------------------------------------------- lifecycle
def _drive_fleet(ctrls, engines, normal, drifted, clock, ticks=6):
    """Both tenants see normal traffic, then the hot one (index 0) drifted
    traffic a tick at a time; each tenant's ``run_once`` outcomes."""
    for engine in engines:
        feed(engine, normal)
    steps = [[ctrl.run_once()] for ctrl in ctrls]
    for _ in range(ticks):
        feed(engines[0], drifted)
        feed(engines[1], normal)
        clock["t"] += 1.0
        for ctrl, seq in zip(ctrls, steps):
            seq.append(ctrl.run_once())
        if sum(steps[0][-1]["promotions"].values()):
            break
    return [[(s["state"], s["drift_triggers"], dict(s["promotions"]), s["generation"])
             for s in seq] for seq in steps]


def test_a_drift_on_one_tenant_promotes_it_alone_as_in_jax(scenery):
    names = ("hot", "quiet")
    clock = {"t": 0.0}
    engines, ctrls = [], []
    base = _no_latency_gate(port_config(scenery["td"] / "port-fleet", scenery["labeled"]))
    for name in names:
        engine = InferenceEngine(scenery["bundle"], buckets=(1, 8), device="cpu")
        engine.warmup()
        engines.append(engine)
        ctrls.append(LifecycleController(engine, tenant_scoped_config(base, name),
                                         clock=lambda: clock["t"]))
    got = _drive_fleet(ctrls, engines, scenery["normal"], scenery["drifted"], clock)

    jclock = {"t": 0.0}
    jbundle = jax_load_bundle(scenery["bundle_dir"])
    jbase = _no_latency_gate(jax_config(scenery["td"] / "jax-fleet", scenery["labeled"]))
    jengines, jctrls = [], []
    for name in names:
        jengine = JaxEngine(jbundle, buckets=(1, 8), enable_grouping=False)
        jengine.warmup()
        jengines.append(jengine)
        jctrls.append(JaxController(jengine, jax_tenant_scoped_config(jbase, name),
                                    clock=lambda: jclock["t"]))
    jnormal, jdrifted = traffic(jbundle.preprocessor)
    want = _drive_fleet(jctrls, jengines, jnormal, jdrifted, jclock)
    assert got == want
    assert got[0][-1] == ("idle", 1, {"promoted": 1, "rejected": 0, "rolled_back": 0}, 2)
    assert got[1][-1][1:] == (0, {"promoted": 0, "rejected": 0, "rolled_back": 0}, 1)
    assert [e.bundle_generation for e in engines] == [2, 1]
    for ctrl in (*ctrls, *jctrls):
        ctrl.stop()
    # Each tenant's state stays under its own directory.
    assert (scenery["td"] / "port-fleet" / "lifecycle" / "hot" / "reservoir.npz").is_file()
    assert not (scenery["td"] / "port-fleet" / "lifecycle" / "reservoir.npz").exists()
    assert set(LIFE_OUTCOMES) == set(got[0][-1][2])
