"""Request tracing on the port (``mlops_tpu_torch/trace/``, the engine's
stamps and shape histograms, the degraded-bucket fallback, the ring's
stitched spans, ``trace-report``) against the JAX package, on the CPU.

- Unit traces: identical stamp sequences through both packages' ``Span``
  (records equal but the wall-clock ``ts``; ``stage_report`` and
  ``format_report`` equal), identical observations through both
  ``ShapeStats`` (snapshots, tables, merges and rendered lines equal), span
  files written by either recorder read by the other, ``trace-report``
  printing what the JAX command prints for the same files and filters.
- The degraded-bucket fallback: with a ready shape removed and its
  capture failing at ``serve.engine.compile``, both engines serve through
  the same larger shape, count it, and answer as the target shape did
  (each package bitwise against itself; across packages the exact tier's
  tolerances of ``test_torch_exact.py``: predictions 1.6e-2 + 1e-6,
  drift 1e-5 + 1e-6).
- End to end: each package's single-process server, armed as its
  ``serve`` arms it, takes the same sequential traffic: the stage sets per
  entry, ``trace-report``'s entries and counts and the observability
  series of ``/metrics`` (names and labels) are equal. The port's ring
  plane (a subprocess: two front ends, two replicas) stitches every
  request's engine half into one span whose stages are the JAX ring's and
  sum to its wall clock (within 1e-3 ms a stage for the 4-place rounding).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mlops_tpu import faults as jax_faults
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.config import SLOConfig as JaxSLOConfig
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.server import HttpServer as JaxHttpServer
from mlops_tpu.slo.ledger import CostLedger as JaxCostLedger
from mlops_tpu.trace import report as jax_report
from mlops_tpu.trace import shapes as jax_shapes
from mlops_tpu.trace.recorder import TraceRecorder as JaxRecorder
from mlops_tpu.trace.span import STAGES as JAX_STAGES
from mlops_tpu.trace.span import Span as JaxSpan
from mlops_tpu_torch import faults
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ServeConfig, SLOConfig, TraceConfig
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.server import HttpServer, arm_observability
from mlops_tpu_torch.slo.ledger import CostLedger
from mlops_tpu_torch.trace import report, shapes
from mlops_tpu_torch.trace.recorder import TraceRecorder
from mlops_tpu_torch.trace.span import STAGES, Span
from torch_observe import LoopServer, arm_jax, observability_labels
from torch_ring import ROOT, Plane, budget, exchange, make_bundle, records  # noqa: F401

EXACT_PRED_ATOL = 1.6e-2 + 1e-6
DRIFT_ATOL = 1e-5 + 1e-6
TENANTS = ("default", "apac", "emea")


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("trace"))


# ------------------------------------------------------------ unit traces
def _span_plan(seed: int) -> list[dict]:
    """Seeded spans: labels, and stamp times that step back now and then
    (the clamp's case)."""
    rng = np.random.default_rng(seed)
    plans = []
    for i in range(40):
        t0 = 1000.0 + float(rng.random()) * 10
        n = int(rng.integers(1, 9))
        stages = [STAGES[j] for j in rng.integers(0, len(STAGES), size=n)]
        times = t0 + np.cumsum(rng.normal(0.002, 0.003, size=n))
        plans.append({
            "trace_id": f"r{seed}-{i}", "plane": ("single", "ring")[i % 2],
            "worker": int(rng.integers(0, 3)), "tenant": TENANTS[i % 3], "t0": t0,
            "replica": int(rng.integers(0, 2)), "rows": int(rng.integers(1, 9)),
            "entry": (None, "bucket_1", "bucket_8@quant", "group_4x1")[i % 4],
            "tier": (None, "quant")[i % 2], "status": (200, 200, 500, 504)[i % 4],
            "stamps": list(zip(stages, times.tolist())),
        })
    return plans


def _drive(cls, plan: dict) -> dict:
    span = cls(plan["trace_id"], plane=plan["plane"], worker=plan["worker"],
               route="/predict", t0=plan["t0"], tenant=plan["tenant"])
    span.replica, span.rows, span.entry, span.tier = (
        plan["replica"], plan["rows"], plan["entry"], plan["tier"])
    for stage, t in plan["stamps"]:
        span.stamp_at(stage, t)
    record = span.finish(plan["status"])
    record.pop("ts")
    return record


def test_the_stage_vocabulary_is_jax():
    assert STAGES == JAX_STAGES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spans_and_the_stage_report_are_jax(seed):
    plans = _span_plan(seed)
    port = [_drive(Span, p) for p in plans]
    jax = [_drive(JaxSpan, p) for p in plans]
    assert port == jax
    for record in port:  # the clamp: no stage is negative
        assert all(ms >= 0 for ms in record["stages"].values())
    got, want = report.stage_report(port), jax_report.stage_report(jax)
    assert got == want
    assert report.format_report(got) == jax_report.format_report(want)


def _observations(seed: int, n: int = 300, entries: int = 12):
    rng = np.random.default_rng(seed)
    names = [f"bucket_{2 ** k}" for k in range(entries // 2)] + [
        f"group_{2 ** k}x8@quant" for k in range(entries - entries // 2)]
    for _ in range(n):
        padded = int(rng.integers(1, 65))
        yield names[int(rng.integers(0, len(names)))], int(rng.integers(0, padded + 1)), padded


@pytest.mark.parametrize("seed,entries", [(0, 12), (1, 40)])
def test_shape_histograms_are_jax(seed, entries):
    port, jax = shapes.ShapeStats(), jax_shapes.ShapeStats()
    for entry, requested, padded in _observations(seed, entries=entries):
        port.observe(entry, requested, padded)
        jax.observe(entry, requested, padded)
    assert port.snapshot() == jax.snapshot()
    assert port.padding_waste_pct() == jax.padding_waste_pct()
    tables = []
    for stats, mod in ((port, shapes), (jax, jax_shapes)):
        keys = np.zeros((mod.TABLE_ROWS, mod.TABLE_KEY_BYTES), np.uint8)
        vals = np.zeros((mod.TABLE_ROWS, mod.TABLE_VALS))
        stats.write_table(keys, vals)
        tables.append((keys, vals, stats.evicted_total))
    np.testing.assert_array_equal(tables[0][0], tables[1][0])
    np.testing.assert_array_equal(tables[0][1], tables[1][1])
    assert tables[0][2] == tables[1][2] == max(0, entries - shapes.TABLE_ROWS)
    read = shapes.read_table(*tables[0][:2])
    assert read == jax_shapes.read_table(*tables[1][:2])
    merged = shapes.merge_entries([read, read])
    assert merged == jax_shapes.merge_entries([read, read])
    assert (shapes.render_entries_lines(merged, 12.5, evicted=3)
            == jax_shapes.render_entries_lines(merged, 12.5, evicted=3))
    reborn, jax_reborn = shapes.ShapeStats(), jax_shapes.ShapeStats()
    reborn.seed(read, t0=5.0)
    jax_reborn.seed(read, t0=5.0)
    assert reborn.snapshot() == jax_reborn.snapshot() and reborn.t0 == jax_reborn.t0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_span_files_read_in_either_package(writer, tmp_path):
    cls = TraceRecorder if writer == "port" else JaxRecorder
    records = [_drive(Span, p) for p in _span_plan(3)]
    recorder = cls(tmp_path / "spans-w0.jsonl", flush_interval_s=30.0)
    for record in records:
        recorder.record(record)
    recorder.close()
    assert report.load_spans(tmp_path) == jax_report.load_spans(tmp_path) == records
    # A full buffer drops and counts, in both.
    drops = []
    for i, rec_cls in enumerate((TraceRecorder, JaxRecorder)):
        small = rec_cls(tmp_path / f"drop{i}.jsonl", capacity=2, flush_interval_s=30.0,
                        on_drop=drops.append)
        for record in records[:5]:
            small.record(record)
        small.close()
        assert small.dropped == 3
    assert drops == [1] * 6


@pytest.mark.parametrize("args", [
    [], ["--tenant", "apac"], ["--replica", "1"], ["--tenant", "emea", "--replica", "0"],
    ["--ledger"],
])
def test_trace_report_prints_what_jax_prints(args, tmp_path, capsys):
    port_rec = TraceRecorder(tmp_path / "spans-w0.jsonl")
    jax_rec = JaxRecorder(tmp_path / "spans-w1.jsonl")
    for i, plan in enumerate(_span_plan(4)):
        (port_rec if i % 2 else jax_rec).record(_drive(Span, plan))
    port_rec.close()
    jax_rec.close()
    for i, cls in enumerate((CostLedger, JaxCostLedger)):
        ledger = cls(tmp_path / "ledger", shard=f"r{i}")
        for entry, requested, padded in _observations(5 + i, n=50):
            ledger.observe(entry, "0a3426a7", requested, padded, padded * 1e-5)
        ledger.close()
    argv = ["trace-report", f"trace.dir={tmp_path}", f"slo.ledger_dir={tmp_path / 'ledger'}",
            *args]
    assert main(argv) == 0
    got = capsys.readouterr()
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert json.loads(got.out)["spans" if "--ledger" not in args else "entries"]


# ------------------------------------------------- degraded fallback
@pytest.fixture(scope="module")
def engines(bundle_dir):
    """The JAX engine compiling on first use, and the port's CPU engine."""
    return (JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64)),
            InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu"))


def _arm_compile_fault(module):
    module.arm(module.FaultPlan.from_rules([{"point": "serve.engine.compile", "mode": "raise"}]))


def test_the_degraded_fallback_serves_as_jax(engines):
    jax, port = engines
    solo, group = records(3, seed=21), [records(1, seed=22 + i) for i in range(2)]
    warm = ([records(10, seed=23)], [records(1, seed=30 + i) for i in range(3)])
    for engine in (jax, port):
        engine.predict_records(warm[0][0])  # bucket 64 ready
        engine.predict_group(warm[1])  # group 4x1 ready
    base = {"jax": (jax.predict_records(solo), jax.predict_group(group)),
            "port": (port.predict_records(solo), port.predict_group(group))}
    jax_before, port_before = jax.degraded_dispatch_total, port.degraded_dispatch_total
    # The target shapes are no longer ready, and readying them fails.
    saved = {k: jax._exec.pop(k) for k in (("bucket", 8), ("group", 2, 1))}
    port._gen.warmed -= {("exact", (8,)), ("exact", (2, 1))}
    for module in (jax_faults, faults):
        _arm_compile_fault(module)
    try:
        jax_handle = jax.dispatch_group_arrays(_encoded(jax, group))
        port_handle = port.dispatch_group_arrays(_encoded(port, group))
        assert (jax_handle.slots, jax_handle.rows) == (port_handle.slots, port_handle.rows) \
            == (4, 1)
        assert port_handle.entry == jax_handle.entry == "group_4x1"
        got = {"jax": (jax.predict_records(solo), jax.fetch_group(jax_handle)),
               "port": (port.predict_records(solo), port.fetch_group(port_handle))}
    finally:
        jax_faults.disarm()
        faults.disarm()
        jax._exec.update(saved)
    assert got == base  # each package bitwise against its own target shape
    assert jax.degraded_dispatch_total - jax_before == 2
    assert port.degraded_dispatch_total - port_before == 2
    for want, have in zip((base["jax"][0], *base["jax"][1]),
                          (got["port"][0], *got["port"][1])):
        np.testing.assert_allclose(have["predictions"], want["predictions"],
                                   atol=EXACT_PRED_ATOL, rtol=0)
        np.testing.assert_allclose(list(have["feature_drift_batch"].values()),
                                   list(want["feature_drift_batch"].values()),
                                   atol=DRIFT_ATOL, rtol=0)
    # With no larger ready shape the failure raises, in both.
    for engine, module, key in ((jax, jax_faults, ("bucket", 64)),
                                (port, faults, ("exact", (64,)))):
        if engine is jax:
            held = engine._exec.pop(key)
        else:
            engine._gen.warmed.discard(key)
        _arm_compile_fault(module)
        try:
            with pytest.raises(module.FaultInjected):
                engine.predict_records(records(20, seed=24))
        finally:
            module.disarm()
            if engine is jax:
                engine._exec[key] = held


def _encoded(engine, group):
    from mlops_tpu_torch.schema.validate import records_to_columns

    parts = []
    for request in group:
        ds = engine.bundle.preprocessor.encode(records_to_columns(request))
        parts.append((ds.cat_ids, ds.numeric))
    return parts


# ----------------------------------------------------------- end to end
def test_the_single_planes_trace_as_jax(bundle_dir, tmp_path):
    slo = dict(enabled=True, ledger_dir=str(tmp_path / "port-ledger"),
               flightrec_dir=str(tmp_path / "port-runs"))
    jax_engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64), tier_routing=True)
    jax_engine.ready = True  # compiles on first use instead of warming
    jax_server = JaxHttpServer(jax_engine, JaxServeConfig(
        host="127.0.0.1", port=0, batch_window_ms=0.0, tier_routing=True).validate())
    jax_slo = JaxSLOConfig(**{**slo, "ledger_dir": str(tmp_path / "jax-ledger"),
                              "flightrec_dir": str(tmp_path / "jax-runs")})
    arm_jax(jax_server, tmp_path / "jax-traces", jax_slo, tmp_path / "jax-ledger")
    from torch_observe import jax_slo_engine

    jax_server.slo_engine = jax_slo_engine(jax_server, jax_slo)
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu",
                             tier_routing=True)
    engine.warmup()
    port_server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0,
                                                 batch_window_ms=0.0, tier_routing=True))
    tracer, ledger = arm_observability(
        port_server, TraceConfig(enabled=True, dir=str(tmp_path / "port-traces")),
        SLOConfig(**slo))
    servers = [LoopServer(jax_server), LoopServer(port_server)]
    try:
        traffic = [(records(1 + i % 5, seed=40 + i), {"x-slo-class": "cheap"} if i % 3 == 0
                    else {}) for i in range(12)]
        texts = []
        for server in servers:
            for body, headers in traffic:
                status, payload = server.request("POST", "/predict",
                                                 json.dumps(body).encode(), headers)
                assert status == 200, payload[:200]
            texts.append(server.request("GET", "/metrics")[1].decode())
    finally:
        for server in servers:
            server.stop()
    spans = [jax_report.load_spans(tmp_path / "jax-traces"),
             report.load_spans(tmp_path / "port-traces")]
    assert [len(s) for s in spans] == [len(traffic)] * 2

    def stage_sets(found):
        return sorted((s["entry"], s.get("tier"), tuple(s["stages"])) for s in found)

    assert stage_sets(spans[1]) == stage_sets(spans[0])
    for span in spans[1]:
        assert abs(sum(span["stages"].values()) - span["wall_ms"]) <= 1e-3 * len(span["stages"])
    got, want = report.stage_report(spans[1]), jax_report.stage_report(spans[0])
    assert ([(g["entry"], g["requests"], g["rows"], sorted(g["stages"])) for g in got["groups"]]
            == [(g["entry"], g["requests"], g["rows"], sorted(g["stages"]))
                for g in want["groups"]])
    assert observability_labels(texts[1]) == observability_labels(texts[0])
    assert 'mlops_tpu_alert_active{alert="engine_down",severity="page",tenant="default"} 0' \
        in texts[1]


def test_the_ring_plane_stitches_every_span(bundle_dir, tmp_path):
    trace_dir = tmp_path / "traces"
    plane = Plane(bundle_dir, tmp_path / "plane.log", overrides=(
        "serve.workers=2", "serve.engine_replicas=2", "serve.tier_routing=true",
        "trace.enabled=true", f"trace.dir={trace_dir}", "trace.flush_interval_s=0.05"))
    try:
        sent = 24
        for i in range(sent):
            status, _, body = exchange(plane.port, "POST", "/predict",
                                       records(1 + i % 3, seed=60 + i),
                                       headers={"x-slo-class": "cheap"} if i % 4 == 0 else None)
            assert status == 200, body[:200]
        rows = sum(len(records(1 + i % 3, seed=60 + i)) for i in range(sent))
        deadline = time.monotonic() + 10
        while True:  # the replicas mirror their histograms every 0.25 s
            text = exchange(plane.port, "GET", "/metrics")[2].decode()
            requested = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                            if line.startswith("mlops_tpu_requested_rows_total{"))
            if requested == rows or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        assert plane.stop() == 0
    spans = report.load_spans(trace_dir)
    assert len(spans) == sent
    assert {p.name for p in trace_dir.iterdir()} <= {"spans-w0.jsonl", "spans-w1.jsonl"}
    ring_stages = tuple(s for s in JAX_STAGES if s != "queue")
    for span in spans:
        assert (span["plane"], span["status"]) == ("ring", 200)
        assert tuple(span["stages"]) == ring_stages  # every engine half stitched
        assert abs(sum(span["stages"].values()) - span["wall_ms"]) <= 1e-3 * len(ring_stages)
        assert span["entry"] in ("bucket_1", "bucket_8")
    assert {s["replica"] for s in spans} <= {0, 1}
    for r in (0, 1):
        out = subprocess.run(
            [sys.executable, "-m", "mlops_tpu_torch", "trace-report", f"trace.dir={trace_dir}",
             "--replica", str(r)], cwd=ROOT, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        assert out.returncode in (0, 2), out.stderr
        got = json.loads(out.stdout)
        assert got["spans"] == sum(s["replica"] == r for s in spans)
    assert "mlops_tpu_trace_dropped_total 0" in text
    assert 'mlops_tpu_shape_occupancy_bucket{entry="bucket_1",le="+Inf"}' in text
    assert requested == rows


def test_priming_the_profiler_needs_a_card_and_a_dir(tmp_path):
    """``TorchProfiler.prime`` initializes CUPTI ahead of the first
    ``/debug/profile/start`` on the card; without a card or a profile
    directory it does nothing and writes nothing."""
    import torch

    from mlops_tpu_torch.serve.server import TorchProfiler

    assert TorchProfiler("").prime() == 0.0
    if not torch.cuda.is_available():
        assert TorchProfiler(str(tmp_path / "profile")).prime() == 0.0
        assert not (tmp_path / "profile").exists()
