"""The port's micro-batcher (``mlops_tpu_torch/serve/batcher.py``): the
policies of the JAX package's ``tests/test_batcher.py``, run against the
port's batcher over the port's engine on the CPU, or over a stub engine
where the JAX test uses one.

The engine serves a small port-written bundle (mlp hidden (32, 16),
embed 4, f32, seeded weights). A grouped dispatch and a solo dispatch of
the same request run the same f32 arithmetic over another batch shape:
predictions within 1e-6, outlier flags equal, drift within 1e-5. Where
the JAX test asks for bit-identical responses (admission modes, perturbed
schedules), so does this one.
"""

import asyncio
import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.config import ModelConfig, ServeConfig, ServeConfigError
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.serve.batcher import MicroBatcher
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.server import HttpServer
from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKET, DeadlineExceeded

PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    columns, _ = generate_synthetic(3000, seed=0)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns))
    config = ModelConfig(family="mlp", hidden_dims=(32, 16), embed_dim=4,
                         precision="f32")
    model = build_model(config)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    path = tmp_path_factory.mktemp("batcher_bundle")
    save_exact_bundle(path, config, model, prep, monitor,
                      calibration={"temperature": 1.3})
    eng = InferenceEngine(load_bundle(path), buckets=(1, 8, 64), device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def sample_record():
    columns, _ = generate_synthetic(1, seed=5)
    return {k: columns[k][0] for k in columns}


def _requests(sample_record, k):
    reqs = []
    for i in range(k):
        rec = dict(sample_record)
        rec["age"] = 20.0 + i
        rec["credit_limit"] = 1000.0 * (i + 1)
        reqs.append([rec] * ((i % 3) + 1))  # sizes 1..3
    return reqs


def _mixed(sample_record, n, seed):
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n):
        rec = dict(sample_record)
        rec["age"] = float(20 + (i % 50))
        rec["bill_amount_1"] = float(rng.integers(100, 5000))
        requests.append([rec] * int(rng.integers(1, GROUP_ROW_BUCKET + 1)))
    return requests


def _assert_close(got, want):
    assert len(got["predictions"]) == len(want["predictions"])
    np.testing.assert_allclose(got["predictions"], want["predictions"],
                               atol=PRED_ATOL, rtol=0)
    assert got["outliers"] == want["outliers"]
    for name, score in want["feature_drift_batch"].items():
        assert got["feature_drift_batch"][name] == pytest.approx(score, abs=DRIFT_ATOL)


def test_grouped_matches_solo(engine, sample_record):
    reqs = _requests(sample_record, 5)
    for req, got in zip(reqs, engine.predict_group(reqs)):
        _assert_close(got, engine.predict_records(req))


def test_a_group_of_one_or_past_64_scores_solo(engine, sample_record):
    """The JAX engine's degenerate handle: one request, or more than the
    largest slot bucket, scores solo and carries formatted responses."""
    counts = engine.dispatch_counts()
    for reqs in (_requests(sample_record, 1), _requests(sample_record, 65)):
        handle = engine.dispatch_group(reqs)
        assert handle.responses is not None
        for req, got in zip(reqs, engine.fetch_group(handle)):
            _assert_close(got, engine.predict_records(req))
    after = engine.dispatch_counts()
    assert not any(after[e] - counts.get(e, 0) for e in after if e.startswith("group_"))
    wire = engine.fetch_group_wire(engine.dispatch_group(_requests(sample_record, 1)))
    assert isinstance(wire[0], bytes)


def test_fetch_ring_sizing_bounds_executor_footprint(engine):
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    b = MicroBatcher(engine, executor, fetch_inflight=2)
    assert b._fetch_ring._value == 2
    b = MicroBatcher(engine, executor, max_inflight=3)  # default: mirror
    assert b._fetch_ring._value == 3
    b = MicroBatcher(engine, executor, fetch_inflight=0)  # floor: 1
    assert b._fetch_ring._value == 1
    executor.shutdown(wait=False)

    # Defaults (8 workers, 4 in flight) leave one thread of headroom.
    server = HttpServer(engine, ServeConfig())
    workers = server._executor._max_workers
    assert server.batcher._inflight._value + server.batcher._fetch_ring._value < workers
    server._executor.shutdown(wait=False)

    cfg = ServeConfig()
    cfg.max_workers = 4
    cfg.max_inflight = 4
    with pytest.raises(ServeConfigError, match="max_inflight"):
        HttpServer(engine, cfg)
    assert (cfg.max_workers, cfg.max_inflight) == (4, 4)  # never mutated


def test_batcher_coalesces_concurrent_requests(engine, sample_record, monkeypatch):
    calls = {"group": 0}
    real = engine.dispatch_group

    def counting(reqs, **kw):
        calls["group"] += 1
        calls["last_size"] = len(reqs)
        return real(reqs, **kw)

    monkeypatch.setattr(engine, "dispatch_group", counting)
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    async def drive():
        batcher = MicroBatcher(engine, executor, window_ms=20.0)
        return await asyncio.gather(
            *(batcher.predict(r) for r in _requests(sample_record, 6))
        )

    responses = asyncio.run(drive())
    executor.shutdown(wait=True)
    assert calls["group"] >= 1
    assert calls["last_size"] > 1, "concurrent requests should coalesce"
    for req, got in zip(_requests(sample_record, 6), responses):
        assert len(got["predictions"]) == len(req)


def test_large_requests_bypass_batcher(engine, sample_record):
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    async def drive():
        batcher = MicroBatcher(engine, executor, window_ms=5.0)
        return await batcher.predict([dict(sample_record)] * (GROUP_ROW_BUCKET + 5))

    response = asyncio.run(drive())
    executor.shutdown(wait=True)
    assert len(response["predictions"]) == GROUP_ROW_BUCKET + 5


def test_disabled_window_runs_solo(engine, sample_record):
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    async def drive():
        batcher = MicroBatcher(engine, executor, window_ms=0.0)
        assert not batcher.enabled
        return await batcher.predict([sample_record])

    response = asyncio.run(drive())
    executor.shutdown(wait=True)
    assert len(response["predictions"]) == 1


def test_overlapped_dispatch_stress_matches_solo(engine, sample_record):
    """100 concurrent mixed-size requests through the batcher return what
    each request gets alone."""
    requests = _mixed(sample_record, 100, seed=9)
    expected = [engine.predict_records(r) for r in requests]

    async def run():
        executor = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        batcher = MicroBatcher(engine, executor, window_ms=1.0)
        try:
            return await asyncio.gather(*[batcher.predict(r) for r in requests])
        finally:
            executor.shutdown(wait=True)

    for got, want in zip(asyncio.run(run()), expected):
        _assert_close(got, want)


class _CountingLock:
    """The engine lock with a count of its acquisitions."""

    def __init__(self, lock):
        self._lock = lock
        self.acquired = 0

    def __enter__(self):
        self._lock.acquire()
        self.acquired += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


@pytest.mark.parametrize("seeds", [(0, 1, 2)])
def test_burst_stress_perturbed_schedules_bit_identical(engine, sample_record,
                                                        monkeypatch, seeds):
    """Seeded random delays around the engine's dispatch and fetch shift
    the interleaving of overlapped dispatches; responses stay bit-identical
    across seeds (group composition is fixed: every co-traveler enqueues
    inside the window), and the hot path ran under the engine lock."""
    requests = []
    for i in range(20):
        rec = dict(sample_record)
        rec["age"] = float(21 + i)
        rec["credit_limit"] = 500.0 * (i + 1)
        requests.append([rec] * ((i % 3) + 1))
    real_dispatch, real_fetch = engine.dispatch_group, engine.fetch_group

    def drive(seed):
        rng = np.random.default_rng(seed)
        jitter = threading.Lock()

        def delay():
            with jitter:
                s = float(rng.uniform(0, 0.001))
            time.sleep(s)

        def dispatch(reqs, **kw):
            delay()
            return real_dispatch(reqs, **kw)

        def fetch(handle):
            delay()
            return real_fetch(handle)

        lock = _CountingLock(engine._acc_lock)
        with monkeypatch.context() as patch:
            patch.setattr(engine, "dispatch_group", dispatch)
            patch.setattr(engine, "fetch_group", fetch)
            patch.setattr(engine, "_acc_lock", lock)

            async def run():
                executor = concurrent.futures.ThreadPoolExecutor(max_workers=8)
                batcher = MicroBatcher(engine, executor, window_ms=20.0,
                                       max_inflight=4)
                try:
                    return await asyncio.gather(*[batcher.predict(r) for r in requests])
                finally:
                    executor.shutdown(wait=True)

            return asyncio.run(run()), lock.acquired

    baseline = None
    for seed in seeds:
        responses, acquired = drive(seed)
        assert acquired >= 1
        assert len(responses) == len(requests)
        if baseline is None:
            baseline = responses
            _assert_close(responses[3], engine.predict_records(requests[3]))
        else:
            assert responses == baseline, f"seed {seed} output diverged"


def test_abandoned_requests_are_purged_at_claim_time(engine, sample_record):
    async def run():
        executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        batcher = MicroBatcher(engine, executor, window_ms=30.0)
        loop = asyncio.get_running_loop()
        for _ in range(5):
            dead = loop.create_future()
            dead.cancel()
            batcher._pending.append(([sample_record], dead, None, None, None))
        live = asyncio.create_task(batcher.predict([sample_record]))
        response = await asyncio.wait_for(live, timeout=30)
        assert 0.0 <= response["predictions"][0] <= 1.0
        assert all(not f.cancelled() for _, f, _, _, _ in batcher._pending)
        executor.shutdown(wait=False)

    asyncio.run(run())


def test_expired_entries_get_deadline_exceeded_without_a_dispatch(engine, sample_record,
                                                                  monkeypatch):
    """An entry whose deadline passed while it queued is completed with
    DeadlineExceeded at claim time; the live one beside it is served."""
    dispatched = []
    real = engine.dispatch_group
    monkeypatch.setattr(engine, "dispatch_group",
                        lambda reqs, **kw: dispatched.append(len(reqs)) or real(reqs, **kw))

    async def run():
        executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        batcher = MicroBatcher(engine, executor, window_ms=30.0)
        loop = asyncio.get_running_loop()
        batcher._last_enqueue = loop.time()  # not idle: both requests queue
        expired = asyncio.create_task(
            batcher.predict([sample_record], deadline=loop.time() + 0.005)
        )
        live = asyncio.create_task(batcher.predict([sample_record, sample_record]))
        with pytest.raises(DeadlineExceeded):
            await expired
        response = await live
        executor.shutdown(wait=False)
        return response

    response = asyncio.run(run())
    assert len(response["predictions"]) == 2
    assert dispatched in ([], [1])  # the expired entry never rode a group


def test_idle_fast_path_skips_window(engine, sample_record):
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    batcher = MicroBatcher(engine, executor, window_ms=200.0)  # huge window

    async def drive():
        t0 = time.perf_counter()
        out = await batcher.predict([sample_record])
        return out, time.perf_counter() - t0

    out, dt = asyncio.run(drive())
    executor.shutdown(wait=True)
    assert 0.0 <= out["predictions"][0] <= 1.0
    assert dt < 0.15, f"idle request waited {dt * 1e3:.0f} ms"
    assert not batcher._pending and not batcher._dispatch_tasks


def test_continuous_and_windowed_bit_identical_under_load(engine, sample_record):
    requests = _mixed(sample_record, 60, seed=17)
    expected = [engine.predict_records(r) for r in requests]

    def drive(mode):
        async def run():
            executor = concurrent.futures.ThreadPoolExecutor(max_workers=8)
            batcher = MicroBatcher(engine, executor, window_ms=1.0, batch_mode=mode)
            try:
                return await asyncio.gather(*[batcher.predict(r) for r in requests])
            finally:
                executor.shutdown(wait=True)

        return asyncio.run(run())

    continuous = drive("continuous")
    windowed = drive("windowed")
    assert continuous == windowed
    for got, want in zip(continuous, expected):
        _assert_close(got, want)


def test_continuous_mode_still_coalesces(engine, sample_record, monkeypatch):
    calls = {"group": 0, "requests": 0}
    real = engine.dispatch_group

    def counting(reqs, **kw):
        calls["group"] += 1
        calls["requests"] += len(reqs)
        return real(reqs, **kw)

    monkeypatch.setattr(engine, "dispatch_group", counting)

    async def drive():
        executor = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        batcher = MicroBatcher(engine, executor, window_ms=1.0, batch_mode="continuous")
        try:
            return await asyncio.gather(
                *(batcher.predict(r) for r in _requests(sample_record, 24))
            )
        finally:
            executor.shutdown(wait=True)

    assert len(asyncio.run(drive())) == 24
    assert calls["group"] < calls["requests"], "nothing coalesced"


def test_continuous_admit_deadline_policy(engine):
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    b = MicroBatcher(engine, executor, window_ms=10.0, batch_mode="continuous",
                     admit_fraction=0.5)
    executor.shutdown(wait=False)
    assert b._admit_deadline_s() == b.window_s  # cold start: full cap
    b._observe_dispatch_s(0.004)
    assert b._dispatch_ewma_s == pytest.approx(0.004)
    assert b._admit_deadline_s() == pytest.approx(0.002)
    b._observe_dispatch_s(0.008)
    assert b._dispatch_ewma_s == pytest.approx(0.8 * 0.004 + 0.2 * 0.008)
    b._dispatch_ewma_s = 1.0  # a slow dispatch never exceeds the cap
    assert b._admit_deadline_s() == b.window_s
    b._dispatch_tasks.add(object())  # in flight: admission is free
    assert b._admit_deadline_s() == 0.0
    b._dispatch_tasks.clear()
    with pytest.raises(ValueError, match="batch_mode"):
        MicroBatcher(engine, None, batch_mode="adaptive")


def test_server_wires_batch_mode_from_config(engine):
    server = HttpServer(
        engine, ServeConfig(batch_mode="windowed", batch_admit_fraction=0.25)
    )
    assert server.batcher.batch_mode == "windowed"
    assert server.batcher.admit_fraction == 0.25
    server._executor.shutdown(wait=False)
    server = HttpServer(engine, ServeConfig())
    assert server.batcher.batch_mode == "continuous"
    assert server.batcher.wire_responses
    server._executor.shutdown(wait=False)


class _StallingEngine:
    """A stub whose calls block until released; its solo entry point
    counts the fast path's calls."""

    supports_grouping = True

    def __init__(self):
        self.release = threading.Event()
        self.solo_calls = 0
        self.group_tiers = []

    def _respond(self):
        self.release.wait(timeout=10)
        return {"predictions": [0.5], "outliers": [0.0], "feature_drift_batch": {}}

    def predict_records(self, records, tier=None):
        self.solo_calls += 1
        return self._respond()

    def predict_group(self, requests, tier=None):
        self.group_tiers.append((tier, len(requests)))
        return [self._respond() for _ in requests]


def test_stalled_solo_pushes_arrivals_back_to_batcher():
    eng = _StallingEngine()
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    batcher = MicroBatcher(eng, executor, window_ms=1.0)

    async def drive():
        first = asyncio.create_task(batcher.predict([{"age": 1.0}]))
        await asyncio.sleep(0.05)  # > window: first went solo and stalled
        assert batcher._solo_inflight == 1
        # The caller is cancelled, but the engine call still holds its
        # executor thread: the counter must not drop.
        first.cancel()
        await asyncio.sleep(0.05)
        assert batcher._solo_inflight == 1
        second = asyncio.create_task(batcher.predict([{"age": 2.0}]))
        await asyncio.sleep(0.05)
        assert eng.solo_calls == 1  # the second did not take the fast path
        eng.release.set()
        await second
        await asyncio.sleep(0.05)

    asyncio.run(drive())
    executor.shutdown(wait=True)
    assert batcher._solo_inflight == 0


def test_a_mixed_tier_queue_splits_into_same_tier_groups():
    """A group runs one program: queued requests of two tiers dispatch as
    one group per tier, in FIFO order within each."""
    eng = _StallingEngine()
    eng.release.set()
    executor = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    batcher = MicroBatcher(eng, executor, window_ms=20.0, max_inflight=1)

    async def drive():
        batcher._last_enqueue = asyncio.get_running_loop().time()  # not idle
        tiers = ["quant", None, "quant", None, None]
        return await asyncio.gather(
            *(batcher.predict([{"age": float(i)}], tier=t) for i, t in enumerate(tiers))
        )

    assert len(asyncio.run(drive())) == 5
    executor.shutdown(wait=True)
    assert sorted(eng.group_tiers, key=str) == sorted([("quant", 2), (None, 3)], key=str)
