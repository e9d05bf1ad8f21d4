"""The port's serving plane under concurrent traffic against the JAX
package's, on the CPU: bursts through the micro-batcher, the request
deadline and ``request_timeout_s``, the monitor cadence, SLO tier routing
with brownout, the docs / health / profile routes, ``tierroute`` and the
serve config's validation.

One port-written flax bundle both packages load: an mlp (hidden
(32, 32, 16), embed 4, bf16) with flax-init weights plus seeded noise,
and a gated quant student beside it. Tolerances are those of
``test_torch_exact.py`` (exact tier: predictions four bf16 ulps of a
logit times the sigmoid's slope, 1.6e-2, plus 1e-6 for the responses'
6-place rounding; drift 1e-5 + 1e-6) and ``test_torch_serve.py`` (quant
tier: predictions 1e-6, drift 1e-5); outlier flags exact except rows
within 1e-5 x threshold of it; monitor rows and batches exact.
"""

import asyncio
import concurrent.futures
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.config import ServeConfigError as JaxServeConfigError
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.monitor import state as jstate
from mlops_tpu.serve import tierroute as jroute
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.httpcore import deadline_response as jax_deadline_response
from mlops_tpu.serve.httpcore import profile_payload as jax_profile_payload
from mlops_tpu.serve.openapi import SWAGGER_HTML as JAX_SWAGGER_HTML
from mlops_tpu.serve.openapi import build_openapi as jax_build_openapi
from mlops_tpu.slo.engine import health_verdict as jax_health_verdict
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.config import ModelConfig, ServeConfig, ServeConfigError
from mlops_tpu_torch.data import Preprocessor
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve import httpcore
from mlops_tpu_torch.serve import tierroute as troute
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.server import HttpServer
from mlops_tpu_torch.serve.wire import DeadlineExceeded
from mlops_tpu_torch.weights import exact_params_from_numpy, load_params, monitor_from_numpy
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

EXACT_PRED_ATOL = 1.6e-2 + 1e-6
QUANT_PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5 + 1e-6
FLAG_BAND = 1e-5
MODEL = dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4, precision="bf16")


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_plane")
    columns, _ = jax_synthetic(3000, seed=0)
    jprep = JaxPreprocessor.fit(columns)
    jmon = jstate.fit_monitor(jprep.encode(columns))
    jprep.save(root / "preprocess.npz")
    prep = Preprocessor.load(root / "preprocess.npz")
    params = jax_init_params(jax_build_model(JaxModelConfig(**MODEL)),
                             jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32),
        params,
    )
    model = load_params(build_model(ModelConfig(**MODEL)),
                        exact_params_from_numpy(params, "cpu")).eval()
    path = root / "bundle"
    save_exact_bundle(
        path, ModelConfig(**MODEL), model, prep,
        monitor_from_numpy(jmon.to_arrays(), "cpu"),
        calibration={"temperature": 1.37},
        quant_params=quantize_student(init_quant_master(0)),
        quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}},
    )
    return path


@pytest.fixture(scope="module")
def jax_engine(bundle_dir):
    return JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64), tier_routing=True)


def _engine(bundle_dir, **kw):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64),
                             device="cpu", **kw)
    engine.warmup()
    return engine


def _records(n, seed, drift=0.0):
    columns, _ = jax_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def _burst(seed):
    """64 single-record requests, then 64 of 1..8 records."""
    rng = np.random.default_rng(seed)
    pool = _records(600, seed, drift=0.3)
    sizes = [1] * 64 + list(rng.integers(1, 9, size=64))
    out, offset = [], 0
    for n in sizes:
        out.append(pool[offset:offset + n])
        offset += n
    return out


def _assert_response(got, want, bundle, records, pred_atol):
    np.testing.assert_allclose(got["predictions"], want["predictions"],
                               atol=pred_atol, rtol=0)
    assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                               list(want["feature_drift_batch"].values()),
                               atol=DRIFT_ATOL, rtol=0)
    ds = bundle.preprocessor.encode(records_to_columns(records))
    mon = bundle.monitor
    diff = ds.numeric.astype(np.float64) - np.asarray(mon.out_mean, np.float64)
    d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(mon.out_precision, np.float64), diff)
    thr = float(mon.out_threshold)
    off = np.abs(d2 - thr) > FLAG_BAND * abs(thr)
    np.testing.assert_array_equal(np.asarray(got["outliers"])[off],
                                  np.asarray(want["outliers"])[off])


class _Server:
    """The port's server on an event loop in a thread, on a free port."""

    def __init__(self, engine, **config):
        self.server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0, **config))
        self.loop = asyncio.new_event_loop()
        self.srv = self.loop.run_until_complete(self.server.start())
        self.port = self.srv.sockets[0].getsockname()[1]
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read(), resp.getheader("content-type")
        finally:
            conn.close()

    def metric(self, name):
        text = self.request("GET", "/metrics")[1].decode()
        for line in text.splitlines():
            if line.startswith(name):
                return float(line.rsplit(" ", 1)[1])
        raise AssertionError(f"no {name} in /metrics")

    def stop(self):
        def shutdown():
            self.server.stop_telemetry()
            self.srv.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(shutdown)
        self.thread.join(timeout=30)
        pending = asyncio.all_tasks(self.loop)
        for task in pending:
            task.cancel()

        async def settle():
            await asyncio.gather(*pending, return_exceptions=True)

        self.loop.run_until_complete(settle())
        self.loop.close()
        self.server.close()


@pytest.fixture
def serving(bundle_dir):
    started = []

    def start(engine=None, **config):
        server = _Server(engine or _engine(bundle_dir), **config)
        started.append(server)
        return server

    yield start
    for server in started:
        server.stop()


# ----------------------------------------------------------- bursts
@pytest.mark.parametrize("batch_mode", ["continuous", "windowed"])
def test_a_burst_through_the_batcher_answers_as_the_jax_engine(
        serving, bundle_dir, jax_engine, batch_mode):
    s = serving(batch_mode=batch_mode, batch_window_ms=20.0)
    requests = _burst(seed=11 if batch_mode == "continuous" else 12)
    bodies = [json.dumps(r).encode() for r in requests]
    with concurrent.futures.ThreadPoolExecutor(64) as pool:
        singles = list(pool.map(lambda b: s.request("POST", "/predict", b), bodies[:64]))
        mixed = list(pool.map(lambda b: s.request("POST", "/predict", b), bodies[64:]))
    jax_engine.monitor_snapshot()
    before = jax_engine.monitor_snapshot()
    jb = jax_load_bundle(bundle_dir)
    for records, (status, body, _) in zip(requests, singles + mixed):
        assert status == 200, body[:200]
        _assert_response(json.loads(body), jax_engine.predict_records(records),
                         jb, records, EXACT_PRED_ATOL)
    want = jax_engine.monitor_snapshot()
    assert s.metric("mlops_tpu_rows_scored_total") == want["rows"] - before["rows"]
    assert s.metric("mlops_tpu_monitor_batches_total") == want["batches"] - before["batches"]
    counts = s.server.engine.dispatch_counts()
    groups = sum(n for e, n in counts.items() if e.startswith("group_"))
    assert groups >= 1 and sum(counts.values()) < len(requests)


def test_batch_window_zero_scores_every_request_alone(serving, bundle_dir, jax_engine):
    s = serving(batch_window_ms=0.0)
    requests = _burst(seed=13)[:32]
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        answers = list(pool.map(
            lambda r: s.request("POST", "/predict", json.dumps(r).encode()), requests))
    jb = jax_load_bundle(bundle_dir)
    for records, (status, body, _) in zip(requests, answers):
        assert status == 200
        _assert_response(json.loads(body), jax_engine.predict_records(records),
                         jb, records, EXACT_PRED_ATOL)
    counts = s.server.engine.dispatch_counts()
    assert sum(counts.values()) == len(requests)
    assert not any(e.startswith("group_") for e in counts)


# --------------------------------------------------------- deadlines
def test_a_deadline_spent_at_admission_answers_the_jax_504(serving, monkeypatch):
    """A slow body parse spends a 1 ms budget: 504 with the JAX body, no
    dispatch, counted in mlops_tpu_deadline_expired_total."""
    real = httpcore.validate_records

    def slow(body):
        time.sleep(0.01)
        return real(body)

    monkeypatch.setattr(httpcore, "validate_records", slow)
    s = serving()
    status, body, _ = s.request("POST", "/predict", json.dumps(_records(1, 3)).encode(),
                                {"x-request-deadline-ms": "1"})
    want = jax_deadline_response()
    assert (status, json.loads(body)) == want[:2]
    assert s.metric("mlops_tpu_deadline_expired_total") == 1
    assert s.server.engine.dispatch_counts() == {}
    # A malformed budget is ignored, as the JAX package ignores it.
    status, _, _ = s.request("POST", "/predict", json.dumps(_records(1, 3)).encode(),
                             {"x-request-deadline-ms": "soon"})
    assert status == 200


def test_a_purged_entry_answers_504_and_counts(bundle_dir):
    """The batcher's claim-time purge raises DeadlineExceeded; the handler
    answers the JAX 504 and counts it."""
    server = HttpServer(_engine(bundle_dir), ServeConfig())

    async def purged(records, deadline=None, tier=None):
        raise DeadlineExceeded()

    server.batcher.predict = purged

    async def drive():
        return await server._score(_records(1, 4), "rid", None, troute.SLO_DEFAULT)

    assert asyncio.run(drive()) == jax_deadline_response()
    assert server.metrics.deadline_expired == 1
    server.close()


@pytest.mark.parametrize("draw,fails,events", [
    (0.1, False, ["InferenceData", "ModelOutput"]),  # sampled
    (0.9, False, []),  # not sampled: a 200 logs nothing
    (0.9, True, ["InferenceData"]),  # not sampled, but an error always logs
])
def test_log_sample_rate_samples_the_event_pair_but_never_an_error(
        bundle_dir, monkeypatch, caplog, draw, fails, events):
    """``serve.log_sample_rate`` as in the JAX package's shell
    (``mlops_tpu/serve/httpcore.py:286-326``): a request is sampled when
    its draw falls under the rate; an unsampled one that does not answer
    200 logs its InferenceData event after the fact."""
    server = HttpServer(_engine(bundle_dir), ServeConfig(log_sample_rate=0.5))
    monkeypatch.setattr(httpcore.random, "random", lambda: draw)
    if fails:
        async def purged(records, deadline=None, tier=None):
            raise DeadlineExceeded()

        server.batcher.predict = purged

    async def drive():
        return await server._predict(json.dumps(_records(2, 5)).encode(), "rid", None,
                                     troute.SLO_DEFAULT)

    with caplog.at_level("INFO", logger="mlops_tpu_torch.serve"):
        status = asyncio.run(drive())[0]
    assert status == (504 if fails else 200)
    logged = [json.loads(r.getMessage())["type"] for r in caplog.records
              if r.getMessage().startswith("{")]
    assert logged == events
    server.close()


def test_request_timeout_answers_504_on_a_stalled_device(serving, bundle_dir, monkeypatch):
    engine = _engine(bundle_dir)
    real = engine.predict_records_wire

    def stalled(records, **kw):
        time.sleep(0.5)
        return real(records, **kw)

    monkeypatch.setattr(engine, "predict_records_wire", stalled)
    s = serving(engine, request_timeout_s=0.1)
    status, body, _ = s.request("POST", "/predict", json.dumps(_records(1, 5)).encode())
    want = jax_deadline_response("prediction exceeded the 0.1s deadline")
    assert (status, json.loads(body)) == want[:2]
    assert s.metric("mlops_tpu_deadline_expired_total") == 0


def test_a_failing_engine_answers_500(serving, bundle_dir, monkeypatch):
    engine = _engine(bundle_dir)

    def broken(records, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "predict_records_wire", broken)
    s = serving(engine)
    status, body, _ = s.request("POST", "/predict", json.dumps(_records(1, 6)).encode())
    assert (status, json.loads(body)) == (500, {"detail": "prediction failed"})


# ----------------------------------------------------- monitor cadence
def test_the_monitor_is_read_after_k_requests_and_on_the_timer(serving):
    s = serving(monitor_fetch_every_requests=3, monitor_fetch_every_s=0.0)
    for i in range(3):
        assert s.request("POST", "/predict", json.dumps(_records(2, 20 + i)).encode())[0] == 200
    deadline = time.monotonic() + 10
    while s.server.metrics.monitor_fetches < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert s.server.metrics.monitor["default"]["rows"] == 6.0
    t = serving(monitor_fetch_every_requests=0, monitor_fetch_every_s=0.05)
    t.request("POST", "/predict", json.dumps(_records(1, 30)).encode())
    deadline = time.monotonic() + 10
    while t.server.metrics.monitor_fetches < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert t.server.metrics.monitor["default"]["rows"] == 1.0


def test_a_scrape_reads_fresh_only_after_traffic(serving):
    s = serving(monitor_fetch_every_requests=0, monitor_fetch_every_s=0.0)
    assert s.metric("mlops_tpu_monitor_fetches_total") == 1  # the first scrape reads
    assert s.metric("mlops_tpu_monitor_fetches_total") == 1  # idle: no new read
    s.request("POST", "/predict", json.dumps(_records(4, 31)).encode())
    assert s.metric("mlops_tpu_rows_scored_total") == 4.0
    assert s.metric("mlops_tpu_monitor_fetches_total") == 2


# ------------------------------------------------------- tier routing
def test_slo_classes_answer_as_the_jax_engine_per_tier(serving, bundle_dir, jax_engine):
    # The deadline case routes by the budget alone: a budget far above
    # any request's time on a loaded host, under the cheap tier's bound.
    s = serving(_engine(bundle_dir, tier_routing=True), tier_routing=True,
                slo_cheap_deadline_ms=5000.0)
    assert s.server.slo_routing
    jb = jax_load_bundle(bundle_dir)
    cases = [({"x-slo-class": "cheap"}, "quant", QUANT_PRED_ATOL),
             ({"x-slo-class": "accurate"}, None, EXACT_PRED_ATOL),
             ({}, None, EXACT_PRED_ATOL),
             ({"x-request-deadline-ms": "4000"}, "quant", QUANT_PRED_ATOL),
             ({"x-slo-class": "warp9"}, None, EXACT_PRED_ATOL)]
    for k, (headers, tier, atol) in enumerate(cases):
        for n in (1, 5):
            records = _records(n, 40 + 10 * k + n, drift=0.2)
            status, body, _ = s.request("POST", "/predict", json.dumps(records).encode(),
                                        headers)
            assert status == 200, (headers, body[:200])
            _assert_response(json.loads(body), jax_engine.predict_records(records, tier=tier),
                             jb, records, atol)
    assert s.metric('mlops_tpu_tier_requests_total{tier="quant"}') == 4
    assert s.metric('mlops_tpu_tier_requests_total{tier="exact"}') == 6
    assert s.metric('mlops_tpu_tier_requests_total{tier="gbm"}') == 0
    assert s.metric("mlops_tpu_tier_demotions_total") == 0
    counts = s.server.engine.dispatch_counts()
    assert sum(n for e, n in counts.items() if e.endswith("@quant")) == 4


def test_routing_stays_off_without_a_second_tier(bundle_dir):
    server = HttpServer(_engine(bundle_dir), ServeConfig(tier_routing=True))
    assert not server.slo_routing and server._brownout is None
    assert server._request_slo({"x-slo-class": "cheap"}) == troute.SLO_DEFAULT
    server.close()


def test_brownout_demotes_default_class_to_the_cheap_tier(bundle_dir, jax_engine):
    engine = _engine(bundle_dir, tier_routing=True)
    server = HttpServer(engine, ServeConfig(tier_routing=True))
    records = _records(3, 60, drift=0.2)

    async def drive(inflight, slo):
        server._score_inflight = inflight
        out = await server._score(records, "rid", None, slo)
        server._score_inflight = 0
        return json.loads(out)

    full = server._score_capacity
    demoted = asyncio.run(drive(full, troute.SLO_DEFAULT))
    pinned = asyncio.run(drive(full, troute.SLO_ACCURATE))
    restored = asyncio.run(drive(0, troute.SLO_DEFAULT))
    jb = jax_load_bundle(bundle_dir)
    _assert_response(demoted, jax_engine.predict_records(records, tier="quant"),
                     jb, records, QUANT_PRED_ATOL)
    for got in (pinned, restored):
        _assert_response(got, jax_engine.predict_records(records), jb, records,
                         EXACT_PRED_ATOL)
    m = server.metrics
    assert (m.tier_demotions, m.brownout_demotions) == (1, 1)
    assert m.tier_requests == {"quant": 1, "gbm": 0, "exact": 2}
    assert (server._brownout.entered, server._brownout.exited) == (1, 1)
    server.close()


def test_the_engine_holds_the_jax_tier_ladder(bundle_dir, jax_engine):
    engine = _engine(bundle_dir, tier_routing=True)
    assert engine.available_tiers == jax_engine.available_tiers == ("quant", "exact")
    for cls in (troute.SLO_DEFAULT, troute.SLO_CHEAP, troute.SLO_ACCURATE):
        assert engine.route_tier(cls) == jax_engine.route_tier(cls)
    quant = InferenceEngine(load_bundle(bundle_dir), buckets=(1,), device="cpu",
                            serve_tier="quant", tier_routing=True)
    jquant = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1,), serve_tier="quant",
                       tier_routing=True)
    assert quant.available_tiers == jquant.available_tiers
    for cls in (troute.SLO_DEFAULT, troute.SLO_CHEAP, troute.SLO_ACCURATE):
        assert quant.route_tier(cls) == jquant.route_tier(cls)
    with pytest.raises(ValueError, match="not committed"):
        _engine(bundle_dir).dispatch_arrays(np.zeros((1, 9), np.int32),
                                            np.zeros((1, 14), np.float32), tier="quant")


HEADERS = ["", "cheap", "default", "accurate", " Cheap ", "ACCURATE", "warp9"]
DEADLINES = [None, 1.0, 20.0, 50.0, 50.5, 1000.0]
CHEAP_MS = [0.0, -1.0, 50.0]


@pytest.mark.parametrize("cheap_ms", CHEAP_MS)
@pytest.mark.parametrize("header", HEADERS)
def test_slo_class_resolution_matches_jax(header, cheap_ms):
    assert troute.parse_slo_class(header) == jroute.parse_slo_class(header)
    for deadline in DEADLINES:
        assert (troute.resolve_slo_class(header, deadline, cheap_ms)
                == jroute.resolve_slo_class(header, deadline, cheap_ms))


@pytest.mark.parametrize("ladder", [("exact",), ("quant", "exact"), ("quant", "gbm", "exact")])
def test_tier_for_class_matches_jax(ladder):
    for default in ladder:
        for cls in (troute.SLO_DEFAULT, troute.SLO_CHEAP, troute.SLO_ACCURATE):
            assert (troute.tier_for_class(ladder, default, cls)
                    == jroute.tier_for_class(ladder, default, cls))


@pytest.mark.parametrize("depths", [(0.75, 0.5), (1.0, 0.0), (0.3, 0.29)])
def test_brownout_governor_matches_jax(depths):
    rng = np.random.default_rng(int(depths[0] * 100))
    ours, theirs = troute.BrownoutGovernor(*depths), jroute.BrownoutGovernor(*depths)
    for pressure in rng.uniform(0, 1.1, size=200):
        assert ours.observe(pressure) == theirs.observe(pressure)
        for cls in (troute.SLO_DEFAULT, troute.SLO_CHEAP, troute.SLO_ACCURATE):
            assert ours.route(cls) == theirs.route(cls)
    assert ({k: getattr(ours, k) for k in troute.BrownoutGovernor.__slots__}
            == {k: getattr(theirs, k) for k in jroute.BrownoutGovernor.__slots__})


@pytest.mark.parametrize("depths", [(0.0, 0.0), (1.5, 0.5), (0.5, 0.5), (0.5, -0.1)])
def test_brownout_governor_refuses_what_jax_refuses(depths):
    with pytest.raises(ValueError) as want:
        jroute.BrownoutGovernor(*depths)
    with pytest.raises(ValueError) as got:
        troute.BrownoutGovernor(*depths)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- routes
def test_docs_openapi_and_health_routes_answer_as_jax(serving, bundle_dir):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    s = serving(engine, service_name="svc")
    status, body, ctype = s.request("GET", "/healthz")
    assert (status, json.loads(body)) == jax_health_verdict(None, False)[:2]
    engine.warmup()
    status, body, ctype = s.request("GET", "/healthz")
    assert (status, json.loads(body)) == jax_health_verdict(None, True)[:2]
    status, body, ctype = s.request("GET", "/openapi.json")
    assert status == 200 and ctype == "application/json"
    assert body == json.dumps(jax_build_openapi("svc"), separators=(",", ":")).encode()
    status, body, ctype = s.request("GET", "/")
    assert (status, ctype) == (200, "text/html")
    assert body.decode() == JAX_SWAGGER_HTML.format(title="svc")
    status, body, ctype = s.request("GET", "/docs/plain")
    assert (status, ctype) == (200, "text/html") and b"POST /predict" in body
    assert s.request("GET", "/nope")[0] == 404


def test_profile_routes_answer_as_jax(serving, tmp_path):
    s = serving(profile_dir=str(tmp_path / "trace"))
    d = str(tmp_path / "trace")
    steps = [("stop", 409), ("start", 200), ("start", 409), ("stop", 200), ("stop", 409)]
    for action, want_status in steps:
        status, body, _ = s.request("POST", f"/debug/profile/{action}")
        want = jax_profile_payload(want_status, action, d)
        assert (status, json.loads(body)) == want[:2], action
    assert any((tmp_path / "trace").iterdir()), "trace output expected in profile_dir"
    status, body, _ = s.request("POST", "/debug/profile/rewind")
    assert (status, json.loads(body)) == (404, {"detail": "not found"})


def test_profile_routes_are_off_without_a_directory(serving):
    s = serving()
    status, body, _ = s.request("POST", "/debug/profile/start")
    assert (status, json.loads(body)) == jax_profile_payload(404, "start", "")[:2]


def test_a_profiler_failure_answers_500(bundle_dir, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    server = HttpServer(_engine(bundle_dir), ServeConfig(profile_dir=str(blocker / "sub")))
    status, payload, _ = asyncio.run(server._profile("start"))
    assert status == 500 and payload["detail"].startswith("profiler start failed: ")
    server.close()


# ------------------------------------------------------------- config
BAD_CONFIGS = [
    dict(max_workers=0),
    dict(max_batch=0),
    dict(max_inflight=7),
    dict(max_workers=2, max_inflight=2),
    dict(batch_window_ms=-1.0),
    dict(max_group=1),
    dict(batch_mode="adaptive"),
    dict(batch_admit_fraction=0.0),
    dict(batch_admit_fraction=1.5),
    dict(serve_tier="fast"),
    dict(brownout_demote_depth=0.0),
    dict(brownout_restore_depth=0.8),
    dict(brownout_demote_depth=0.4, brownout_restore_depth=0.5),
    dict(drain_deadline_s=0.0),
    dict(max_workers=3, max_group=0, batch_mode="x", serve_tier="y"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_config_validation_errors_match_jax(kw):
    with pytest.raises(JaxServeConfigError) as want:
        JaxServeConfig(**kw).validate()
    with pytest.raises(ServeConfigError) as got:
        ServeConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_the_port_keeps_the_jax_serve_defaults():
    want = JaxServeConfig()
    for field in ServeConfig.__dataclass_fields__:
        if field != "device":
            assert getattr(ServeConfig(), field) == getattr(want, field), field
    assert ServeConfig().validate() is not None


def test_a_failed_warmup_stops_the_server(bundle_dir, monkeypatch):
    """Warmup failure (a kernel build, a graph capture) closes the socket
    and exits non-zero, never a forever-503."""
    from mlops_tpu_torch.serve.server import serve

    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1,), device="cpu")

    def broken():
        raise RuntimeError("capture failed")

    monkeypatch.setattr(engine, "warmup", broken)
    with pytest.raises(SystemExit, match="warmup failed: capture failed"):
        asyncio.run(asyncio.wait_for(
            serve(engine, ServeConfig(host="127.0.0.1", port=0)), timeout=60))
