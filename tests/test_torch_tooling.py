"""The port's tooling against the JAX package's, on the CPU:
``utils/flops`` (the H100's own peaks; ``mfu`` and a matmul's count equal
to JAX's), ``utils/debug`` (``checked`` bitwise around the packed
programs, a planted NaN named, ``check_encoded_inputs``'s messages),
``utils/timing`` (the values of the three modules that kept their own
copies), the event-loop lag sanitizer armed on both serving planes and
its series against the JAX planes', and the runtime lock sanitizer over the port's in-process ring
(the counterparts of the JAX suite's forked planes, which the port boots
only as subprocesses), its replica set, its tenant fleet and the engine's
warmup, under the JAX suite's perturbation seeds."""

import asyncio
import contextlib
import json
import math
import re
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from mlops_tpu.serve.ipc import RequestRing as JaxRing
from mlops_tpu.serve.metrics import ServingMetrics as JaxMetrics
from mlops_tpu.serve.metrics import render_ring_metrics as jax_render_ring
from mlops_tpu.utils import debug as jax_debug
from mlops_tpu.utils import flops as jax_flops
from mlops_tpu.utils import timing as jax_timing
from mlops_tpu_torch.analysis.lockcheck import LockSanitizer, instrument_locks
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import ServeConfig, ServeConfigError
from mlops_tpu_torch.ops.cuda_build import LaunchCounter
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.ipc import RequestRing, RingClient, RingService
from mlops_tpu_torch.serve.metrics import render_ring_metrics
from mlops_tpu_torch.serve.server import Metrics
from mlops_tpu_torch.serve.wire import encode_response
from mlops_tpu_torch.utils import debug, flops, timing
from torch_ring import Plane, make_bundle, records

SXM = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("tooling"))


def _engine(bundle_dir, **kw):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu",
                             tier_routing=True, **kw)
    engine.warmup()
    return engine


# ------------------------------------------------------------------ flops
@pytest.mark.parametrize("args", [
    (None, 10.0, 1e12), (1e9, 10.0, None), (1e9, 100.0, 1e12), (3.3e9, 7.0, 989e12),
    (1.5089e9, 1234.5, 67e12), (2e9, 0.0, 1e12), (2e9, -1.0, 1e12),
])
def test_mfu_is_the_jax_formula(args):
    port, jax = flops.mfu(*args), jax_flops.mfu(*args)
    assert (port is None) == (jax is None)
    if port is not None:
        assert abs(port - jax) <= 1e-12


def test_a_matmul_counts_the_flops_jax_s_cost_model_counts():
    import jax.numpy as jnp

    n = 128
    _, jax_count = jax_flops.compile_with_flops(lambda a, b: a @ b, jnp.ones((n, n)),
                                                jnp.ones((n, n)))
    fn, count = flops.compile_with_flops(lambda a, b: a @ b, torch.ones(n, n), torch.ones(n, n))
    assert count == jax_count == 2 * n**3
    assert torch.equal(fn(torch.ones(n, n), torch.ones(n, n)), torch.full((n, n), float(n)))
    assert flops.compiled_flops(lambda a, b: a @ b, torch.ones(n, n), torch.ones(n, n)) == count
    assert flops.compile_with_flops(lambda x: undefined_name + x, 1.0) == (None, None)  # noqa: F821


@pytest.mark.parametrize("name,part,bf16,f32", [
    (SXM, "sxm", 989e12, 67e12), ("NVIDIA H100 SXM5 80GB", "sxm", 989e12, 67e12),
    ("NVIDIA H100 PCIe", "pcie", 756e12, 51e12), ("NVIDIA H100 NVL", "nvl", 835e12, 60e12),
    ("NVIDIA H100", None, None, None), ("NVIDIA A100-SXM4-80GB", None, None, None),
    ("cpu", None, None, None),
])
def test_the_peak_table_tells_the_h100_parts_apart(name, part, bf16, f32, monkeypatch):
    monkeypatch.delenv("MLOPS_TPU_PEAK_FLOPS", raising=False)
    assert flops.h100_part(name) == part
    assert flops.peak_flops(name) == flops.peak_flops(name, "fp16") == bf16
    assert flops.peak_flops(name, "f32") == f32
    if part is not None:
        # The card's ratios, not a TPU's: f32 off the tensor cores is
        # about 1/15 of dense bf16 (JAX's TPU table says 1/2).
        assert 13 < bf16 / f32 < 16 and jax_flops._DTYPE_SCALE["f32"] == 0.5
        fp8 = flops.peak_flops(name, "fp8")
        assert flops.peak_flops(name, "int8") == fp8 and abs(fp8 / bf16 - 2) < 1e-2
        assert abs(flops.peak_flops(name, "tf32") / bf16 - 0.5) < 1e-2
    monkeypatch.setenv("MLOPS_TPU_PEAK_FLOPS", "5e12")
    assert flops.peak_flops(name, "f32") == 5e12  # verbatim, no dtype scaling
    with pytest.raises(ValueError, match="unknown executing dtype"):
        flops.peak_flops(name, "f64")


def test_the_bounds_chip_smoke_states_come_from_the_table():
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == flops.peak_bytes_per_s(SXM) == 3.35e12
    assert chip_smoke.BF16_TC_FLOPS == flops.peak_flops(SXM) == 989e12
    assert chip_smoke.F32_OPS_PER_S == flops.peak_flops(SXM, "f32") == 67e12
    with pytest.raises(ValueError, match="times the card"):
        flops.measured_gemm_peak(device="cpu")


# ------------------------------------------------------------------ debug
def _encoded(n=3):
    return (np.zeros((n, SCHEMA.num_categorical), np.int32),
            np.zeros((n, SCHEMA.num_numeric), np.float32))


def _bad_inputs():
    cat, num = _encoded()
    oov = cat.copy()
    oov[1, 2] = 10_000
    neg = cat.copy()
    neg[0, 5] = -1
    nan = num.copy()
    nan[0, 0] = np.nan
    return {"oov": (oov, num), "negative": (neg, num), "nan": (cat, nan),
            "cat-shape": (cat[:, :3], num), "num-shape": (cat, num[:2])}


@pytest.mark.parametrize("case", ["oov", "negative", "nan", "cat-shape", "num-shape"])
def test_check_encoded_inputs_raises_the_jax_messages(case):
    cat, num = _bad_inputs()[case]
    with pytest.raises(ValueError) as jax_err:
        jax_debug.check_encoded_inputs(cat, num)
    for cat_in, num_in in ((cat, num), (torch.from_numpy(cat), torch.from_numpy(num))):
        with pytest.raises(ValueError) as err:
            debug.check_encoded_inputs(cat_in, num_in)
        assert str(err.value) == str(jax_err.value)
    debug.check_encoded_inputs(*_encoded())  # clean


def test_checked_names_the_op_and_passes_sentinels():
    assert torch.equal(debug.checked(lambda x: torch.log(x + 1.0))(torch.ones(4)),
                       torch.log(torch.ones(4) + 1.0))
    with pytest.raises(debug.NumericCheckError, match="aten.log.default") as err:
        debug.checked(lambda x: torch.log(x) * 2)(-torch.ones(4))
    assert err.value.op == "aten.log.default"
    with pytest.raises(debug.NumericCheckError, match="aten.div"):
        debug.checked(lambda x: x / 0.0)(torch.ones(3))
    # An infinite sentinel and its copies pass, as checkify lets them.
    sentinel = debug.checked(lambda x: torch.full_like(x, float("inf")).clamp(max=3.0) + x)
    assert torch.equal(sentinel(torch.ones(3)), torch.full((3,), 4.0))


def test_checked_tests_a_kernel_s_outputs_through_its_counter():
    counter = LaunchCounter("planted_kernel")

    def launch(x, poison):
        out = torch.empty_like(x)  # a kernel's buffer: uninitialized, never tested
        # A ctypes kernel's writes are invisible to the dispatch mode.
        with _disable_current_modes():
            out.copy_(x)
            if poison:
                out.view(-1)[0] = float("nan")
        counter.add(outputs=(out,))
        return out

    def swallow(x):
        # A kernel whose outputs drop a NaN it read: caught at its operand.
        out = torch.empty_like(x)
        with _disable_current_modes():
            out.copy_(torch.nan_to_num(x))
        counter.add(outputs=(out,), inputs=(x,))
        return out

    x = torch.ones(4)
    assert torch.equal(debug.checked(launch)(x, False), x)
    with pytest.raises(debug.NumericCheckError, match="kernel planted_kernel"):
        debug.checked(lambda t: launch(t, True) * 1.0)(x)
    assert torch.equal(debug.checked(swallow)(x), x)
    poisoned = torch.tensor([1.0, float("nan")])
    with pytest.raises(debug.NumericCheckError, match=r"kernel planted_kernel \(an operand\)"):
        debug.checked(swallow)(poisoned)
    assert counter.value == 4


@pytest.mark.parametrize("tier", ["quant", "exact"])
def test_checked_packed_programs_are_bitwise_and_name_a_planted_nan(bundle_dir, tier):
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
    )
    from mlops_tpu_torch.ops.quant_kernel import make_quant_grouped_base, make_quant_packed_base

    bundle = load_bundle(bundle_dir)
    model = bundle.model.eval()
    params, solo, grouped = {
        "quant": (bundle.quant_params, make_quant_packed_base(), make_quant_grouped_base()),
        "exact": (model_params(model), make_packed_predict_base(model),
                  make_packed_grouped_base(model)),
    }[tier]
    ds = bundle.preprocessor.encode(records_to_columns(records(512, seed=5, drift=0.2)))
    temp = torch.tensor(1.25)
    for s, r in ((1, 1), (1, 256), (64, 8)):
        cat = torch.from_numpy(ds.cat_ids[: s * r].astype(np.int32))
        num = torch.from_numpy(ds.numeric[: s * r].astype(np.float32))
        mask = torch.ones((s, r), dtype=torch.bool)
        if s > 1:
            cat, num = cat.reshape(s, r, -1), num.reshape(s, r, -1)
        else:
            mask = mask[0]
        program = solo if s == 1 else grouped
        args = (params, bundle.monitor, init_accumulator("cpu"), temp, cat, num, mask)
        want, got = program(*args), debug.checked(program)(*args)
        assert torch.equal(want[0], got[0])
        for field in ("rows", "outliers", "batches", "drift_sum", "drift_last"):
            assert torch.equal(getattr(want[1], field), getattr(got[1], field))
        bad = num.clone()
        bad.view(-1)[3] = float("nan")
        with pytest.raises(debug.NumericCheckError, match=r"produced by aten\."):
            debug.checked(program)(params, bundle.monitor, init_accumulator("cpu"), temp,
                                   cat, bad, mask)


# ----------------------------------------------------------------- timing
def test_the_timing_helpers_give_the_jax_values():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        values = sorted(rng.exponential(3.0, n).tolist())
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            port, jax = timing.percentile(values, q), jax_timing.percentile(values, q)
            assert (math.isnan(port) and math.isnan(jax)) or port == jax
            samples = rng.normal(size=n).tolist()
            want = float(np.percentile(np.asarray(samples, np.float64), q)) if n else 0.0
            assert timing.interpolated_percentile(samples, q) == want
    sunk = []
    clock = timing.StageClock(sink=lambda *a: sunk.append(a[0]))
    with clock.stage("read", items=3):
        time.sleep(0.001)
    with clock.stage("read"):
        pass
    report = clock.report(1.0)
    assert report["read"]["items"] == 4 and sunk == ["read", "read"]
    assert set(report["read"]) == set(jax_timing.StageClock().report(1.0).get("read", report["read"]))
    with timing.Timer() as t:
        time.sleep(0.002)
    assert t.ms >= 2.0
    from mlops_tpu_torch.data import pipeline_exec
    from mlops_tpu_torch.lifecycle import shadow
    from mlops_tpu_torch.trace import report as trace_report

    assert pipeline_exec.StageClock is timing.StageClock
    assert trace_report.percentile is timing.percentile
    assert shadow.interpolated_percentile is timing.interpolated_percentile


# ------------------------------------------------------- the loop sanitizer
def _names(text: str) -> set[str]:
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def _lag_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if "mlops_tpu_event_loop_lag_ms" in line]


# The series one package renders and the other does not: JAX's build info
# (its jax/jaxlib versions), the port's dispatches and kernel launches, and
# on the ring the supervisor's down-since clock.
JAX_ONLY = {"mlops_tpu_build_info"}
PORT_ONLY = {"mlops_tpu_dispatches_total", "mlops_tpu_kernel_launches_total"}


@pytest.mark.parametrize("lag", [None, 0.0, 12.3456])
def test_the_series_of_both_planes_are_the_jax_planes_monitor_on_and_off(lag):
    snapshot = {"rows": 3, "outliers": 1, "batches": 1, "drift_sum": [0.0] * 23,
                "drift_last": {"age": 0.5}, "drift_mean": {"age": 0.25}}
    jax, port = JaxMetrics(), Metrics()
    for m in (jax, port):
        m.observe_request("/predict", 200, 3.0)
        m.set_monitor_aggregate(snapshot)
        if lag is not None:
            m.set_loop_lag(lag)
    jax_text, port_text = jax.render(), port.render({"solo_1@exact": 1})
    assert _names(port_text) - PORT_ONLY == _names(jax_text) - JAX_ONLY
    assert _lag_lines(port_text) == _lag_lines(jax_text)
    kw = dict(workers=3, slots_small=2, slots_large=1, large_rows=8)
    ring, jax_ring = RequestRing(**kw), JaxRing(**kw)
    try:
        if lag is not None:
            for w in range(3):
                ring.loop_lag_ms[w] = jax_ring.loop_lag_ms[w] = lag * w
        jax_text, port_text = jax_render_ring(jax_ring), render_ring_metrics(ring)
        assert (_names(port_text) - PORT_ONLY - {"mlops_tpu_engine_down_since"}
                == _names(jax_text) - JAX_ONLY)
        assert _lag_lines(port_text) == _lag_lines(jax_text)
        assert len(_lag_lines(port_text)) == 4
    finally:
        ring.close()
        jax_ring.close()


@pytest.mark.parametrize("slow_ms", [0.0, -5.0])
def test_a_non_positive_slow_threshold_is_refused_with_the_jax_message(slow_ms):
    from mlops_tpu.config import ServeConfig as JaxServeConfig
    from mlops_tpu.config import ServeConfigError as JaxServeConfigError

    with pytest.raises(JaxServeConfigError) as want:
        JaxServeConfig(loop_lag_slow_ms=slow_ms).validate()
    with pytest.raises(ServeConfigError) as got:
        ServeConfig(loop_lag_slow_ms=slow_ms).validate()
    assert str(got.value) == str(want.value)


def test_the_single_process_plane_arms_the_sanitizer_and_drains_it_per_scrape(
        bundle_dir, caplog, monkeypatch):
    """``serve`` with ``serve.loop_lag_monitor`` on: the sanitizer is armed
    on the server's loop, a stall on the loop shows in the next scrape's
    ``worker="0"`` cell, the window resets on read, and the drain
    detaches it."""
    import logging
    import threading

    from torch_ring import exchange, free_port

    from mlops_tpu_torch.serve import server as server_mod

    caplog.set_level(logging.INFO)
    port = free_port()
    config = ServeConfig(host="127.0.0.1", port=port, loop_lag_monitor=True,
                         loop_lag_slow_ms=20.0)
    made = []
    real = server_mod.HttpServer

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(server_mod, "HttpServer", recording)
    loop = asyncio.new_event_loop()
    try:
        task = loop.create_task(server_mod.serve(_engine(bundle_dir), config))
        thread = threading.Thread(target=loop.run_until_complete, args=(task,), daemon=True)
        thread.start()
        deadline = time.monotonic() + 60
        while True:
            try:
                if exchange(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and thread.is_alive()
            time.sleep(0.02)
        server = made[0]
        assert server.loop_monitor is not None
        assert exchange(port, "POST", "/predict", json.dumps(records(3, seed=9)).encode())[0] == 200
        exchange(port, "GET", "/metrics")  # drain the window
        loop.call_soon_threadsafe(time.sleep, 0.05)  # a stall the next scrape reads
        lines = _lag_lines(exchange(port, "GET", "/metrics")[2].decode())
        assert lines[0] == "# TYPE mlops_tpu_event_loop_lag_ms gauge" and len(lines) == 2
        assert lines[1].startswith('mlops_tpu_event_loop_lag_ms{worker="0"} ')
        stalled = float(lines[1].rsplit(" ", 1)[1])
        assert stalled >= 40.0
        assert any("sleep" in r.label for r in server.loop_monitor.slow)
        quiet = _lag_lines(exchange(port, "GET", "/metrics")[2].decode())
        assert float(quiet[1].rsplit(" ", 1)[1]) < stalled  # the window reset on read
        loop.call_soon_threadsafe(task.cancel)
        thread.join(timeout=60)
        assert not thread.is_alive() and server.loop_monitor is None
        assert "call_soon" not in vars(loop)  # detached
    finally:
        loop.close()
    assert "loop-lag sanitizer armed (slow_ms=20)" in caplog.text


def test_the_ring_plane_arms_the_sanitizer_per_front_end(bundle_dir, tmp_path):
    plane = Plane(bundle_dir, tmp_path / "plane.log",
                  overrides=("serve.workers=2", "serve.loop_lag_monitor=true",
                             "serve.loop_lag_slow_ms=50"))
    try:
        from torch_ring import exchange

        for n in (1, 3, 8):
            assert exchange(plane.port, "POST", "/predict",
                            json.dumps(records(n, seed=n)).encode())[0] == 200
        time.sleep(1.2)  # two watchdog passes
        text = exchange(plane.port, "GET", "/metrics")[2].decode()
        lines = _lag_lines(text)
        assert lines[0] == "# TYPE mlops_tpu_event_loop_lag_ms gauge" and len(lines) == 3
        for w, line in enumerate(lines[1:]):
            assert line.startswith(f'mlops_tpu_event_loop_lag_ms{{worker="{w}"}} ')
            lag = float(line.rsplit(" ", 1)[1])
            assert math.isfinite(lag) and lag >= 0.0
        log = plane.text()
        for w in range(2):
            assert f"frontend {w}: loop-lag sanitizer armed (slow_ms=50)" in log
    finally:
        assert plane.stop() == 0


# ------------------------------------------------------ the lock sanitizer
def test_engine_warmup_runs_under_its_declared_lock_order(bundle_dir):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    with instrument_locks(engine) as san:
        engine.warmup()
    assert san.violations == [], [str(v) for v in san.violations]
    assert san.acquired.get("_acc_lock", 0) >= 1
    assert engine.predict_records(records(1, seed=2))["predictions"]


def _ring_burst(engines, ring_kw, seed, tenants_of):
    """Requests through an in-process ring, one service per replica, with
    every service's, the ring's and the engines' locks instrumented and
    the services' schedules perturbed by ``seed``; returns each answer's
    wire bytes and the sanitizers."""
    bodies = [records(n, seed=40 + n, drift=0.2) for n in (1, 3, 8, 1, 5, 2, 8, 1)]
    replicas = ring_kw.get("replicas", 1)

    async def run():
        ring = RequestRing(**ring_kw)
        ring_san = LockSanitizer(order=("_submit_locks", "_complete_locks", "_profile_lock"),
                                 perturb_seed=seed)
        ring._submit_locks = [ring_san.wrap(lock, "_submit_locks") for lock in ring._submit_locks]
        ring._complete_locks = [ring_san.wrap(lock, "_complete_locks")
                                for lock in ring._complete_locks]
        services = [RingService(engines[0], ring, engines=engines, max_inflight=2, threads=2,
                                monitor_fetch_every_s=0, replica=r) for r in range(replicas)]
        sanitizers = [ring_san]
        out = []
        with contextlib.ExitStack() as stack:
            for service in services:
                sanitizers.append(stack.enter_context(
                    instrument_locks(service, perturb_seed=seed)))
            for engine in engines:
                sanitizers.append(stack.enter_context(
                    instrument_locks(engine, perturb_seed=seed)))
            loop = asyncio.get_running_loop()
            client = RingClient(ring, 0)
            try:
                for r, service in enumerate(services):
                    service.reattach()
                    service.start()
                    ring.set_ready(True, r)
                    loop.add_reader(ring.worker_doorbell(0, r).fileno(), client.on_doorbell, r)
                futures = []
                for i, recs in enumerate(bodies):
                    tenant = tenants_of(i)
                    ds = engines[tenant].bundle.preprocessor.encode(records_to_columns(recs))
                    slot = client.claim(len(recs), tenant=tenant)
                    futures.append((slot, client.submit(slot, ds.cat_ids, ds.numeric,
                                                        replica=i % replicas)))
                for slot, future in futures:
                    assert await asyncio.wait_for(future, 60) == 0
                    out.append(encode_response(*client.response_arrays(slot)))
                    client.release(slot)
            finally:
                for r in range(replicas):
                    loop.remove_reader(ring.worker_doorbell(0, r).fileno())
                for service in services:
                    service.stop()
                ring.close()
        return out, sanitizers

    answers, sanitizers = asyncio.run(run())
    want = [engines[tenants_of(i)].predict_records_wire(recs) for i, recs in enumerate(bodies)]
    return answers, want, sanitizers



@pytest.fixture(scope="module")
def ring_engines(bundle_dir, tmp_path_factory):
    """One engine per tenant bundle, shared by the ring cases (a case's
    sanitizers wrap and restore their locks)."""
    other = make_bundle(tmp_path_factory.mktemp("tenant_b"), seed=3)
    return [_engine(bundle_dir), _engine(other)]


@pytest.mark.parametrize("plane,seed", [
    ("ring", 0), ("ring", 1), ("ring", 2),
    ("replicas", 0), ("replicas", 1), ("replicas", 2),
    ("tenants", 0), ("tenants", 1),
])
def test_the_ring_holds_its_lock_order_under_perturbed_schedules(ring_engines, plane, seed):
    """The JAX suite's ring, replica-set and tenancy sanitizer tests over
    the port's in-process ring: no order violation in any sanitizer, and
    every answer the engine's own bytes."""
    if plane == "tenants":
        engines = ring_engines
        kw = dict(workers=1, slots_small=8, slots_large=1, large_rows=8,
                  tenant_names=("emea", "apac"))
        tenants_of = lambda i: i % 2  # noqa: E731
    else:
        engines = ring_engines[:1]
        kw = dict(workers=1, slots_small=8, slots_large=1, large_rows=8,
                  replicas=2 if plane == "replicas" else 1)
        tenants_of = lambda i: 0  # noqa: E731
    answers, want, sanitizers = _ring_burst(engines, kw, seed, tenants_of)
    assert answers == want
    for san in sanitizers:
        assert not san.violations, [str(v) for v in san.violations]
    assert sanitizers[0].acquired.get("_submit_locks") and sanitizers[0].acquired.get(
        "_complete_locks")
    assert any(san.acquired.get("_inflight") for san in sanitizers[1:])
