"""The ring plane (``serve/frontend.py``) booted as the serving image
boots it, ``python -m mlops_tpu_torch serve`` with ``serve.workers=2``,
in a subprocess on the CPU, against the port's single-process server and
the JAX engine; the non-slow cases of the JAX package's
``tests/test_frontend.py``.

- answers byte for byte the single-process server's (``serve.workers=0``
  on the same bundle), empty to 64 records;
- a concurrent burst (64 single-record and 64 mixed 1..8-record
  requests, every fourth ``x-slo-class: cheap``) against the JAX engine's
  per-tier answers, with ``test_torch_serving_plane.py``'s tolerances:
  exact-tier predictions 1.6e-2 + 1e-6 (four bf16 ulps of a logit times
  the sigmoid's slope), quant-tier 1e-6, drift 1e-5 + 1e-6, flags exact
  off the 1e-5 threshold band;
- the HTTP edge cases on both planes; /metrics with every worker and the
  monitor aggregate; the engine's kill -9 (a brownout: the respawned
  engine answers as its predecessor did, the counters stay monotone); a
  front end's kill -9;
- with a stub engine that holds slots (``tests/torch_ring_stub.py``): the
  overload shed (fast 503 + Retry-After), brownout demotion before the
  shed, an accurate request never demoted, the SIGTERM drain (every
  child exits 0), the brownout shed of an engine outage (Retry-After
  within the respawn ETA, parked requests answered);
- ``ServeConfig.validate``'s ring-plane messages against the JAX
  package's.
"""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.config import ServeConfigError as JaxServeConfigError
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.config import ServeConfig, ServeConfigError
from mlops_tpu_torch.schema.validate import records_to_columns
from torch_ring import Plane, budget, exchange, make_bundle, records  # noqa: F401

EXACT_PRED_ATOL = 1.6e-2 + 1e-6
QUANT_PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5 + 1e-6
FLAG_BAND = 1e-5
ROUTING = ("serve.tier_routing=true",)


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("frontend"))


@pytest.fixture(scope="module")
def ring(bundle_dir, tmp_path_factory):
    plane = Plane(bundle_dir, tmp_path_factory.mktemp("logs") / "ring.log",
                  ("serve.workers=2", *ROUTING))
    yield plane
    assert plane.stop() == 0


@pytest.fixture(scope="module")
def single(bundle_dir, tmp_path_factory):
    plane = Plane(bundle_dir, tmp_path_factory.mktemp("logs") / "single.log",
                  ("serve.workers=0", *ROUTING))
    yield plane
    assert plane.stop() == 0


def _stub(tmp_path, overrides, **env):
    return Plane(tmp_path, tmp_path / "stub.log", overrides, stub=True,
                 env={k.upper(): str(v) for k, v in env.items()})


def _stub_bundle(tmp_path, bundle_dir):
    """The stub needs only a preprocessor beside it."""
    (tmp_path / "preprocess.npz").write_bytes((bundle_dir / "preprocess.npz").read_bytes())
    return tmp_path


def _predict(port, body, headers=None):
    status, got_headers, payload = exchange(port, "POST", "/predict", body, headers)
    return status, got_headers, payload


def _concurrently(calls, n_threads=16):
    results = [None] * len(calls)
    work = iter(range(len(calls)))
    lock = threading.Lock()

    def run():
        while True:
            with lock:
                i = next(work, None)
            if i is None:
                return
            results[i] = calls[i]()

    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


# ---------------------------------------------------------------- answers
def test_two_worker_answers_are_the_single_process_answers_byte_for_byte(ring, single):
    for n in (0, 1, 3, 8, 20, 64):
        body = json.dumps(records(n, seed=10 + n, drift=0.2)).encode() if n else b"[]"
        for headers in (None, {"x-slo-class": "cheap"}):
            got = _predict(ring.port, body, headers)
            want = _predict(single.port, body, headers)
            assert got[0] == want[0] == 200
            assert got[2] == want[2], f"{n} records, {headers}"


def test_a_concurrent_burst_agrees_with_the_jax_engine(ring, bundle_dir):
    """64 single-record and 64 mixed requests from 16 threads, every
    fourth asking for the cheap class (the quant tier): each answer against
    the JAX engine's on the same tier; the grouped path served some."""
    jb = jax_load_bundle(bundle_dir)
    jax_engine = JaxEngine(jb, buckets=(1, 8, 64), tier_routing=True)
    rng = np.random.default_rng(7)
    pool = records(700, seed=7, drift=0.3)
    sizes = [1] * 64 + list(rng.integers(1, 9, size=64))
    bounds = np.cumsum([0, *sizes])
    requests = [pool[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    cheap = [i % 4 == 0 for i in range(len(requests))]
    before = sum(v for k, v in _dispatches(ring).items())
    answers = _concurrently([
        (lambda r=r, c=c: _predict(ring.port, json.dumps(r).encode(),
                                   {"x-slo-class": "cheap"} if c else None))
        for r, c in zip(requests, cheap)
    ])
    counts = _dispatches(ring)
    assert sum(counts.values()) - before < len(requests)
    assert any(k.startswith("group_") for k in counts)
    mon = jb.monitor
    for recs, is_cheap, (status, _, body) in zip(requests, cheap, answers):
        assert status == 200
        got = json.loads(body)
        want = jax_engine.predict_records(recs, tier="quant" if is_cheap else None)
        np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=0,
                                   atol=QUANT_PRED_ATOL if is_cheap else EXACT_PRED_ATOL)
        assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
        np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                                   list(want["feature_drift_batch"].values()),
                                   atol=DRIFT_ATOL, rtol=0)
        ds = jb.preprocessor.encode(records_to_columns(recs))
        diff = ds.numeric.astype(np.float64) - np.asarray(mon.out_mean, np.float64)
        d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(mon.out_precision, np.float64), diff)
        off = np.abs(d2 - float(mon.out_threshold)) > FLAG_BAND * abs(float(mon.out_threshold))
        np.testing.assert_array_equal(np.asarray(got["outliers"])[off],
                                      np.asarray(want["outliers"])[off])


def _dispatches(plane) -> dict[str, float]:
    text = exchange(plane.port, "GET", "/metrics")[2].decode()
    return {line.split('"')[1]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line.startswith("mlops_tpu_dispatches_total{")}


# ------------------------------------------------------- HTTP edge cases
def _recv(f):
    status_line = f.readline()
    if not status_line:
        return None
    status = int(status_line.split(b" ")[1])
    headers = {}
    while (line := f.readline()) not in (b"\r\n", b"\n", b""):
        name, _, value = line.decode("latin1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers, f.read(int(headers.get("content-length", 0)))


def _raw(port, data: bytes, close_check=False):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(data)
        with sock.makefile("rb") as f:
            got = _recv(f)
            if close_check:
                assert f.readline() == b"", "the connection must close"
            return got


@pytest.mark.parametrize("plane", ["ring", "single"])
def test_http_edge_cases(plane, request):
    port = request.getfixturevalue(plane).port
    # Pipelined keep-alive: three requests before any response is read.
    body = b"[{}]"
    one = (b"POST /predict HTTP/1.1\r\nhost: t\r\n"
           + f"content-length: {len(body)}\r\n\r\n".encode() + body)
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(one * 3)
        with sock.makefile("rb") as f:
            for _ in range(3):
                status, _, payload = _recv(f)
                assert status == 200 and len(json.loads(payload)["predictions"]) == 1
    # An oversized declared body: 413 before it is read.
    status, _, payload = _raw(port, b"POST /predict HTTP/1.1\r\nhost: t\r\n"
                                    b"content-length: 999999999\r\n\r\n")
    assert status == 413 and b"exceeds" in payload
    # Malformed Content-Length, the spellings RFC 9110 forbids included.
    for bad in (b"abc", b"-1", b"+5", b"1_0"):
        status, _, _ = _raw(port, b"POST /predict HTTP/1.1\r\nhost: t\r\ncontent-length: "
                                  + bad + b"\r\n\r\n")
        assert status == 400, bad
    # Transfer-Encoding: 400, and the connection closes.
    status, _, _ = _raw(port, b"POST /predict HTTP/1.1\r\nhost: t\r\n"
                              b"transfer-encoding: chunked\r\n\r\n5\r\nAAAAA\r\n0\r\n\r\n",
                        close_check=True)
    assert status == 400
    # Two Content-Length lines: 400.
    status, _, _ = _raw(port, b"POST /predict HTTP/1.1\r\nhost: t\r\n"
                              b"content-length: 4\r\ncontent-length: 30\r\n\r\n[{}]")
    assert status == 400
    # A client gone mid-body: the server shrugs it off.
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(b"POST /predict HTTP/1.1\r\nhost: t\r\ncontent-length: 100\r\n\r\n0123")
    status, _, payload = _predict(port, b"[{}]")
    assert status == 200 and len(json.loads(payload)["predictions"]) == 1
    # 422 and 413 on a body over max_batch, as the single-process server.
    assert _predict(port, b'[{"age": "old"}]')[0] == 422
    assert _predict(port, json.dumps([{}] * 65).encode())[0] == 413


# ---------------------------------------------------------------- metrics
def test_metrics_show_every_worker_and_the_monitor_aggregate(ring):
    # Earlier tests' rows may still be on their way into the aggregate:
    # start from a settled one (the engine writes it every 2 s).
    before = -1.0
    while (now := ring.metric("mlops_tpu_rows_scored_total")) != before:
        before = now
        time.sleep(2.5)
    body = json.dumps(records(3, seed=2)).encode()
    for _ in range(4):
        assert _predict(ring.port, body)[0] == 200
    deadline = time.monotonic() + 15  # the engine's telemetry cadence (2 s)
    while ring.metric("mlops_tpu_rows_scored_total") < before + 12:
        assert time.monotonic() < deadline, "the monitor aggregate never counted the rows"
        time.sleep(0.1)
    assert exchange(ring.port, "GET", "/healthz/live")[:3:2] == (200, b'{"status":"alive"}')
    assert exchange(ring.port, "GET", "/healthz/ready")[:3:2] == (200, b'{"status":"ready"}')
    assert json.loads(exchange(ring.port, "GET", "/healthz")[2])["verdict"] == "ok"
    text = exchange(ring.port, "GET", "/metrics")[2].decode()
    for worker in (0, 1):
        for series in ("mlops_tpu_ring_depth", "mlops_tpu_shed_total"):
            assert f'{series}{{worker="{worker}",class="small",tenant="default"}}' in text
        assert f'mlops_tpu_request_latency_ms_count{{worker="{worker}"' in text
    assert 'route="/predict",status="200",worker="' in text
    for series in ("mlops_tpu_feature_drift_score{", "mlops_tpu_feature_drift_mean{",
                   "mlops_tpu_monitor_fetches_total", "mlops_tpu_engine_incarnation 1",
                   "mlops_tpu_engine_down_since 0.0", 'mlops_tpu_kernel_launches_total{kernel='):
        assert series in text, series
    assert ring.metric("mlops_tpu_rows_scored_total") == before + 12


# ------------------------------------------------------------ respawns
def test_an_engine_kill9_is_a_brownout_and_the_respawn_answers_alike(bundle_dir, tmp_path):
    """kill -9 of the engine: requests sent meanwhile park and are
    answered by the respawned engine (no nvcc, on the CPU none is needed),
    whose answers equal its predecessor's byte for byte; the respawn, the
    incarnation and the monotone monitor rows show in /metrics."""
    plane = Plane(bundle_dir, tmp_path / "ring.log", ("serve.workers=2", *ROUTING))
    try:
        bodies = [json.dumps(records(n, seed=30 + n)).encode() for n in (1, 5, 8, 12)]
        before = [_predict(plane.port, b) for b in bodies]
        deadline = time.monotonic() + 15
        while plane.metric("mlops_tpu_rows_scored_total") < 26:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        os.kill(plane.pids()["engine"], signal.SIGKILL)
        parked = [_predict(plane.port, b) for b in bodies]  # the first parks
        for (s0, _, b0), (s1, _, b1) in zip(before, parked):
            assert s0 == s1 == 200 and b0 == b1
        assert plane.metric("mlops_tpu_engine_respawn_total") == 1
        assert plane.metric("mlops_tpu_engine_incarnation") == 2
        assert plane.metric("mlops_tpu_rows_scored_total") >= 26
        ready = [json.loads(line.split("ready ", 1)[1]) for line in plane.text().splitlines()
                 if line.startswith("warmup complete; ready {")]
        assert [r["incarnation"] for r in ready] == [1, 2]
        assert all(r["nvcc_calls"] == 0 for r in ready)
    finally:
        assert plane.stop() == 0


def test_a_killed_front_end_is_respawned(bundle_dir, tmp_path):
    plane = _stub(_stub_bundle(tmp_path, bundle_dir), ("serve.workers=2",), stub_delay_s=0.0)
    try:
        victim = plane.pids()["frontend 0"]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while plane.pids()["frontend 0"] == victim or (
                f"frontend 0 serving" not in plane.text().split(f"pid {victim})")[-1]):
            assert time.monotonic() < deadline, "front end 0 was not respawned"
            time.sleep(0.05)
        for _ in range(8):  # both listeners live
            assert _predict(plane.port, b"[{}]")[0] == 200
    finally:
        assert plane.stop() == 0


# ------------------------------------------------- shedding and draining
def test_an_overload_burst_sheds_fast_503_with_retry_after(bundle_dir, tmp_path):
    plane = _stub(_stub_bundle(tmp_path, bundle_dir),
                  ("serve.workers=2", "serve.ring_slots_small=1", "serve.ring_slots_large=1"),
                  stub_delay_s=0.5)
    try:
        results = _concurrently([(lambda: _timed(plane.port)) for _ in range(12)], 12)
        statuses = [s for s, _, _ in results]
        assert statuses.count(200) >= 1
        sheds = [r for r in results if r[0] == 503]
        assert sheds, statuses
        for _, headers, elapsed in sheds:
            assert headers.get("retry-after") == "1"
            assert elapsed < 0.45, f"a shed took {elapsed:.3f} s"
        assert plane.metric('mlops_tpu_shed_total{worker="0",class="small"') + plane.metric(
            'mlops_tpu_shed_total{worker="1",class="small"') + plane.metric(
            'mlops_tpu_shed_total{worker="0",class="large"') + plane.metric(
            'mlops_tpu_shed_total{worker="1",class="large"') == len(sheds)
    finally:
        assert plane.stop() == 0


def _timed(port, headers=None):
    t0 = time.perf_counter()
    status, got_headers, _ = _predict(port, b"[{}]", headers)
    return status, got_headers, time.perf_counter() - t0


def test_brownout_demotes_the_default_class_before_shedding(bundle_dir, tmp_path):
    plane = _stub(_stub_bundle(tmp_path, bundle_dir),
                  ("serve.workers=2", "serve.ring_slots_small=8", "serve.ring_slots_large=2",
                   *ROUTING), stub_delay_s=0.5, stub_tiers="quant,exact")
    try:
        statuses = [s for s, _, _ in _concurrently(
            [(lambda: _timed(plane.port)) for _ in range(40)], 40)]
        assert set(statuses) <= {200, 503}, statuses
        assert statuses.count(200) >= 16 and statuses.count(503) >= 1, statuses
        demoted = plane.metric("mlops_tpu_tier_demotions_total")
        assert demoted >= 1
        assert plane.metric("mlops_tpu_brownout_demote_total") == demoted
        assert plane.metric('mlops_tpu_tier_requests_total{tier="quant"}') >= demoted
    finally:
        assert plane.stop() == 0


def test_an_explicit_accurate_request_is_never_demoted(bundle_dir, tmp_path):
    plane = _stub(_stub_bundle(tmp_path, bundle_dir),
                  ("serve.workers=2", "serve.ring_slots_small=2", "serve.ring_slots_large=1",
                   *ROUTING), stub_delay_s=0.5, stub_tiers="quant,exact")
    try:
        accurate = {"x-slo-class": "accurate"}
        statuses = [s for s, _, _ in _concurrently(
            [(lambda: _timed(plane.port, accurate)) for _ in range(12)], 12)]
        assert statuses.count(200) >= 1 and set(statuses) <= {200, 503}
        assert plane.metric("mlops_tpu_tier_demotions_total") == 0
        assert plane.metric('mlops_tpu_tier_requests_total{tier="quant"}') == 0
        assert plane.metric('mlops_tpu_tier_requests_total{tier="exact"}') == statuses.count(200)
    finally:
        assert plane.stop() == 0


def test_sigterm_drains_in_flight_requests_and_every_child_exits_zero(bundle_dir, tmp_path):
    plane = _stub(_stub_bundle(tmp_path, bundle_dir), ("serve.workers=2",), stub_delay_s=0.8)
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("r", _predict(plane.port, b"[{}]")))
    thread.start()
    time.sleep(0.3)  # the exchange reaches the engine
    pids = plane.pids()
    plane.proc.send_signal(signal.SIGTERM)
    thread.join(timeout=30)
    status, _, payload = result["r"]
    assert status == 200 and json.loads(payload)["predictions"] == [0.25]
    assert plane.stop() == 0
    text = plane.text()
    for worker in (0, 1):
        assert f"frontend {worker} (pid {pids[f'frontend {worker}']}) exited 0" in text
    assert f"engine replica 0 (pid {pids['engine']}) exited 0" in text


def test_an_engine_outage_parks_admissions_and_its_shed_advertises_the_respawn_eta(
        bundle_dir, tmp_path):
    """kill -9 of the engine, whose successor takes 4 s to warm: the
    admissions park (two small slots and a large one per worker), the
    rest shed with a Retry-After within the respawn ETA, and the parked
    ones are answered once the successor is up."""
    plane = _stub(_stub_bundle(tmp_path, bundle_dir),
                  ("serve.workers=2", "serve.ring_slots_small=2", "serve.ring_slots_large=1",
                   "serve.engine_respawn_eta_s=7"),
                  stub_delay_s=0.0, stub_respawn_warmup_s=4.0, stub_mark=tmp_path / "mark")
    try:
        os.kill(plane.pids()["engine"], signal.SIGKILL)
        deadline = time.monotonic() + 10
        while plane.metric("mlops_tpu_engine_down_since") == 0:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.setdefault(i, _timed(plane.port)))
                   for i in range(20)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while (plane.metric("mlops_tpu_parked_requests")
               + plane.metric("mlops_tpu_brownout_shed_total")) < 20:
            assert time.monotonic() < deadline, "admissions neither parked nor shed"
            time.sleep(0.02)
        assert plane.metric("mlops_tpu_parked_requests") == 6
        for t in threads:
            t.join(timeout=30)
        statuses = [results[i][0] for i in range(20)]
        assert statuses.count(200) == 6 and statuses.count(503) == 14, statuses
        for status, headers, _ in results.values():
            if status == 503:
                assert 1 <= int(headers["retry-after"]) <= 7
        assert plane.metric("mlops_tpu_brownout_shed_total") == 14
        assert plane.metric("mlops_tpu_parked_requests") == 0
        assert plane.metric("mlops_tpu_engine_down_since") == 0
    finally:
        assert plane.stop() == 0


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("kw", [
    dict(workers=-1),
    dict(workers=2, ring_slots_small=0),
    dict(workers=2, ring_slots_large=0),
    dict(workers=2, shed_retry_after_s=0),
    dict(workers=2, engine_respawn_eta_s=0.0),
    dict(zygote_join_deadline_s=10.0),
    dict(engine_zygote_join_s=39.0),
    dict(log_sample_rate=0.0),
    dict(workers=2, ring_slots_small=0, shed_retry_after_s=0, log_sample_rate=2.0),
])
def test_an_inconsistent_geometry_is_refused_with_the_jax_messages(kw):
    with pytest.raises(JaxServeConfigError) as want:
        JaxServeConfig(**kw).validate()
    with pytest.raises(ServeConfigError) as got:
        ServeConfig(**kw).validate()
    assert str(got.value) == str(want.value)
    assert ServeConfig(workers=2).validate().workers == 2
