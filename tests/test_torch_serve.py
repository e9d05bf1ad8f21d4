"""The port serves a JAX-trained quant bundle like the JAX engine does.

One module-scoped JAX training run with ``train.distill_quant=true``
makes the bundle (the ``tests/test_quant.py`` geometry). The port loads
it, serves it on the CPU (``device="cpu"``: the plain-torch route) and is
held against ``mlops_tpu``'s quant-tier engine. Tolerances:

- predictions 1e-6 absolute (f32 matmuls summed in another order);
- drift 1e-5 absolute (p-values; responses round drift to 6 places);
- outlier flags exact except rows within 1e-5 x threshold of it;
- monitor totals: rows, outliers and batches exact, drift means 1e-5.
"""

import asyncio
import http.client
import json
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pydantic
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.schema import LoanApplicant
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.bundle import load_bundle, save_quant_bundle
from mlops_tpu_torch.config import ServeConfig, load_config
from mlops_tpu_torch.data import generate_synthetic
from mlops_tpu_torch.schema.validate import records_to_columns, validate_records
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.server import HttpServer
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5
FLAG_BAND = 1e-5


@pytest.fixture(scope="module")
def quant_pipeline(tmp_path_factory):
    """One training run with the quant tier opted in: teacher, monitors
    and the graded int8/bf16 student in one bundle."""
    from mlops_tpu.config import Config, ModelConfig, TrainConfig
    from mlops_tpu.train.pipeline import run_training

    root = tmp_path_factory.mktemp("torch_quant_pipeline")
    config = Config()
    config.data.rows = 3000
    config.model = ModelConfig(family="mlp", hidden_dims=(32, 32), embed_dim=4)
    config.train = TrainConfig(
        steps=100, eval_every=100, batch_size=256, distill_quant=True
    )
    config.registry.root = str(root / "registry")
    config.registry.run_root = str(root / "runs")
    return run_training(config).bundle_dir


@pytest.fixture(scope="module")
def bundles(quant_pipeline):
    return jax_load_bundle(quant_pipeline), load_bundle(quant_pipeline)


def _records(n, seed, drift=0.0):
    columns, _ = generate_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def _assert_response(got, want, bundle, records):
    np.testing.assert_allclose(
        got["predictions"], want["predictions"], atol=PRED_ATOL, rtol=0
    )
    assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    np.testing.assert_allclose(
        list(got["feature_drift_batch"].values()),
        list(want["feature_drift_batch"].values()),
        atol=DRIFT_ATOL, rtol=0,
    )
    ds = bundle.preprocessor.encode(records_to_columns(records))
    mon = bundle.monitor
    diff = ds.numeric.astype(np.float64) - np.asarray(mon.out_mean, np.float64)
    d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(mon.out_precision, np.float64), diff)
    thr = float(mon.out_threshold)
    off = np.abs(d2 - thr) > FLAG_BAND * abs(thr)
    np.testing.assert_array_equal(
        np.asarray(got["outliers"])[off], np.asarray(want["outliers"])[off]
    )


# ------------------------------------------------------------------ bundle
def test_loader_matches_jax_loader_bitwise(bundles):
    jb, tb = bundles
    assert set(tb.quant_params) == set(jb.quant_params)
    for key, leaf in jb.quant_params.items():
        got = tb.quant_params[key]
        if key == "embed":
            want_bits = np.asarray(leaf).view(np.uint16)
            got_bits = got.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got_bits, want_bits)
        else:
            assert got.numpy().dtype == np.asarray(leaf).dtype, key
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    for key, arr in jb.monitor.to_arrays().items():
        np.testing.assert_array_equal(getattr(tb.monitor, key).numpy(), arr)
    for key, arr in jb.preprocessor.to_arrays().items():
        np.testing.assert_array_equal(tb.preprocessor.to_arrays()[key], arr)
    assert tb.quant_temperature == jb.quant_temperature
    assert tb.quant_gates_passed is jb.quant_gates_passed is True
    assert tb.manifest == jb.manifest


@pytest.mark.parametrize("field", ["quant_format", "schema_fingerprint"])
def test_loader_refuses_foreign_format_and_schema(quant_pipeline, tmp_path, field):
    copy = tmp_path / "bundle"
    shutil.copytree(quant_pipeline, copy)
    manifest = json.loads((copy / "manifest.json").read_text())
    if field == "quant_format":
        manifest["quant"]["format"] = "int4-dense/v0"
        match = "format"
    else:
        manifest["schema_fingerprint"] = "0" * 16
        match = "schema"
    (copy / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match=match):
        load_bundle(copy)
    with pytest.raises(ValueError, match=match):
        jax_load_bundle(copy)


def test_port_written_bundle_reads_back_in_both_packages(bundles, tmp_path):
    from mlops_tpu.data.encode import Preprocessor as JaxPreprocessor
    from mlops_tpu.monitor.state import MonitorState as JaxMonitorState
    from mlops_tpu.ops.quant import quant_params_from_arrays

    _, tb = bundles
    save_quant_bundle(
        tmp_path, tb.preprocessor, tb.monitor, tb.quant_params,
        temperature=tb.quant_temperature, gates={"passed": True},
    )
    back = load_bundle(tmp_path)
    for key, leaf in tb.quant_params.items():
        assert back.quant_params[key].equal(leaf), key
    with np.load(tmp_path / "quant_params.npz") as data:
        jq = quant_params_from_arrays({k: data[k] for k in data.files})
    for key, leaf in jq.items():
        np.testing.assert_array_equal(
            np.asarray(leaf.astype(jnp.float32)),
            tb.quant_params[key].float().numpy(),
        )
    jm = JaxMonitorState.load(tmp_path / "monitor.npz")
    for key, arr in jm.to_arrays().items():
        np.testing.assert_array_equal(getattr(tb.monitor, key).numpy(), arr)
    jp = JaxPreprocessor.load(tmp_path / "preprocess.npz")
    assert jp.schema_fingerprint == tb.preprocessor.schema_fingerprint


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engines(bundles):
    jb, tb = bundles
    return (
        JaxEngine(jb, serve_tier="quant"),
        InferenceEngine(tb, serve_tier="quant", device="cpu"),
    )


def test_engine_refuses_ungraded_or_unported_tiers(bundles, tmp_path):
    """The exact tier is the default; a bundle without exact params
    refuses it, an ungraded quant tier refuses quant, an unknown tier is
    refused, and sharded params (``serve.model_shards``, which loads)
    refuse the quant tier with the JAX engine's message."""
    jb, tb = bundles
    assert InferenceEngine(tb, device="cpu").serve_tier == "exact"
    with pytest.raises(ValueError, match="serve_tier"):
        InferenceEngine(tb, serve_tier="int4", device="cpu")
    assert load_config(["serve.model_shards=2"]).serve.model_shards == 2

    class two_shards:  # a ('model',) mesh of 2 ranks, as the tier table reads it
        @staticmethod
        def size(axis):
            return 2

    with pytest.raises(ValueError) as want:
        JaxEngine(jb, buckets=(1,), serve_tier="quant", model_shards=2)
    with pytest.raises(ValueError) as got:
        InferenceEngine(tb, serve_tier="quant", device="cpu", mesh=two_shards)
    assert str(got.value) == str(want.value)
    save_quant_bundle(tmp_path, tb.preprocessor, tb.monitor, tb.quant_params)
    with pytest.raises(ValueError, match="promotion gates"):
        InferenceEngine(load_bundle(tmp_path), serve_tier="quant", device="cpu")
    with pytest.raises(ValueError, match="no exact-tier params"):
        InferenceEngine(load_bundle(tmp_path), device="cpu")


@pytest.mark.parametrize("n", [1, 5, 64, 256])
def test_engine_matches_jax_engine(engines, bundles, sample_request, n):
    jax_engine, engine = engines
    records = sample_request if n == 1 else _records(n, seed=n, drift=0.3)
    _assert_response(
        engine.predict_records(records), jax_engine.predict_records(records),
        bundles[1], records,
    )
    wire = engine.predict_records_wire(records)
    assert json.loads(wire) == engine.predict_records(records)


@pytest.mark.parametrize("rows", [1, 8])
def test_grouped_dispatch_matches_jax_engine(engines, bundles, rows):
    jax_engine, engine = engines
    records = _records(40 * rows, seed=50 + rows, drift=0.3)
    sizes = [rows] * 5 + [1, max(1, rows - 3)] * 2
    parts, groups, offset = [], [], 0
    ds = bundles[1].preprocessor.encode(records_to_columns(records))
    for n in sizes:
        parts.append((ds.cat_ids[offset:offset + n], ds.numeric[offset:offset + n]))
        groups.append(records[offset:offset + n])
        offset += n
    got = engine.fetch_group(engine.dispatch_group_arrays(parts))
    want = jax_engine.fetch_group(jax_engine.dispatch_group_arrays(parts))
    assert len(got) == len(want) == len(parts)
    for g, w, recs in zip(got, want, groups):
        _assert_response(g, w, bundles[1], recs)


def test_monitor_snapshot_totals_match_jax_engine(bundles):
    jb, tb = bundles
    jax_engine = JaxEngine(jb, buckets=(1, 8, 64), serve_tier="quant")
    engine = InferenceEngine(tb, buckets=(1, 8, 64), serve_tier="quant", device="cpu")
    ds = tb.preprocessor.encode(records_to_columns(_records(200, 7, drift=0.5)))
    for lo, hi in ((0, 1), (1, 9), (9, 60), (60, 61)):
        for eng in (jax_engine, engine):
            eng.predict_arrays(ds.cat_ids[lo:hi], ds.numeric[lo:hi])
    parts = [(ds.cat_ids[i:i + 3], ds.numeric[i:i + 3]) for i in range(100, 130, 3)]
    for eng in (jax_engine, engine):
        eng.fetch_group(eng.dispatch_group_arrays(parts))
    want, got = jax_engine.monitor_snapshot(), engine.monitor_snapshot()
    for key in ("rows", "outliers", "batches"):
        assert got[key] == want[key], key
    assert got["rows"] == 61 + 30 and got["batches"] == 4 + 10
    np.testing.assert_allclose(
        list(got["drift_mean"].values()), list(want["drift_mean"].values()),
        atol=DRIFT_ATOL, rtol=0,
    )
    np.testing.assert_allclose(got["drift_sum"], want["drift_sum"], atol=DRIFT_ATOL)


def test_warmup_leaves_the_monitor_untouched(bundles):
    engine = InferenceEngine(bundles[1], buckets=(1, 8), serve_tier="quant", device="cpu")
    engine.warmup()
    assert engine.ready and engine.warmup_stats["programs"] == 2 + 12
    snap = engine.monitor_snapshot()
    assert snap["rows"] == snap["batches"] == 0.0


# -------------------------------------------------------------------- http
def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def http_server(bundles):
    engine = InferenceEngine(
        bundles[1], buckets=(1, 8, 64), serve_tier="quant", device="cpu"
    )
    server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0))
    loop = asyncio.new_event_loop()
    srv = loop.run_until_complete(server.start())
    port = srv.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield server, engine, port
    loop.call_soon_threadsafe(srv.close)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)
    assert not thread.is_alive()
    loop.close()
    server.close()


def test_http_predict_matches_jax_engine(http_server, engines, bundles, sample_request):
    server, engine, port = http_server
    status, _ = _request(port, "GET", "/healthz/ready")
    assert status == 503  # not warmed yet
    engine.warmup()
    assert _request(port, "GET", "/healthz/ready")[0] == 200
    assert _request(port, "GET", "/healthz/live")[0] == 200
    status, body = _request(
        port, "POST", "/predict", json.dumps(sample_request).encode()
    )
    assert status == 200
    want = engines[0].predict_records(sample_request)
    _assert_response(json.loads(body), want, bundles[1], sample_request)


def test_http_error_statuses_and_metrics(http_server):
    server, engine, port = http_server
    status, body = _request(
        port, "POST", "/predict", json.dumps(_records(65, 3)).encode()
    )
    assert status == 413 and b"max_batch=64" in body
    status, body = _request(port, "POST", "/predict", b'[{"sex": 1}]')
    assert status == 422
    detail = json.loads(body)["detail"]
    assert detail[0]["type"] == "string_type" and detail[0]["loc"] == [0, "sex"]
    assert _request(port, "POST", "/predict", b"not json")[0] == 422
    assert _request(port, "GET", "/nope")[0] == 404
    status, _ = _request(port, "POST", "/predict", json.dumps(_records(7, 4)).encode())
    assert status == 200
    status, text = _request(port, "GET", "/metrics")
    assert status == 200
    text = text.decode()
    assert 'mlops_tpu_requests_total{route="/predict",status="413",tenant="default"} 1' in text
    assert "mlops_tpu_kernel_launches_total" in text
    rows = [line for line in text.splitlines() if line.startswith("mlops_tpu_rows_scored_total")]
    assert float(rows[0].rsplit(" ", 1)[1]) >= 7


# -------------------------------------------------------------- validation
BODIES = [
    "[]", "{}", "[1]", "[{}]", '[{"sex": 1}]', '[{"sex": "unseen"}]',
    '[{"age": "35"}]', '[{"age": " 35 "}]', '[{"age": "abc"}]',
    '[{"age": true}]', '[{"age": null}]', '[{"age": NaN}]',
    '[{"age": Infinity}]', '[{"age": [1]}]', '[{"age": "1_000"}]',
    '[{"age": "inf"}]', '[{"age": "0x10"}]', '[{"age": ""}]',
    '[{"age": "\\u0661\\u0662"}]', '[{"sex": null}]', '[{"sex": true}]',
    '[{"extra": 1, "age": 2.5}]', '[{"age": 1}, 2, {"sex": 3, "age": "x"}]',
    "not json", '[{"credit_limit": 12345678901234567890}]',
    '[{"age": "1e3", "education": "others"}]',
]


@pytest.mark.parametrize("body", BODIES)
def test_validator_agrees_with_pydantic(body):
    adapter = pydantic.TypeAdapter(list[LoanApplicant])
    records, errors = validate_records(body.encode())
    try:
        want = [r.model_dump() for r in adapter.validate_json(body)]
    except pydantic.ValidationError as err:
        want_errors = [(e["type"], list(e["loc"])) for e in err.errors()]
        assert records is None
        assert [(e["type"], e["loc"]) for e in errors] == want_errors
        return
    assert errors == []
    assert len(records) == len(want)
    for got, exp in zip(records, want):
        assert got.keys() == exp.keys()
        for key in exp:
            if isinstance(exp[key], float) and np.isnan(exp[key]):
                assert np.isnan(got[key])
            else:
                assert got[key] == exp[key] and type(got[key]) is type(exp[key])


# --------------------------------------------------------------------- cli
def test_load_config_parses_positional_overrides():
    from mlops_tpu_torch.config import load_config

    cfg = load_config([
        "serve.port=5001", "serve.device=cpu",
        "serve.warmup_batch_sizes=1,8", "serve.drain_deadline_s=2.5",
    ]).serve
    assert (cfg.port, cfg.device, cfg.warmup_batch_sizes) == (5001, "cpu", (1, 8))
    assert cfg.drain_deadline_s == 2.5
    for bad in ("serve.nope=1", "hpo.nope=3", "serve.port"):
        with pytest.raises(KeyError):
            load_config([bad])


def test_cli_serves_on_the_cpu_and_drains_on_sigterm(quant_pipeline, tmp_path):
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = tmp_path / "server.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={quant_pipeline}", f"serve.port={port}",
             "serve.host=127.0.0.1", "serve.device=cpu",
             "serve.warmup_batch_sizes=1,8", "serve.serve_tier=quant"],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
            stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log.read_text()
            try:
                if _request(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)
        records = _records(3, 9)
        status, body = _request(port, "POST", "/predict", json.dumps(records).encode())
        assert status == 200 and len(json.loads(body)["predictions"]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = log.read_text()
    events = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    assert [e["type"] for e in events] == ["InferenceData", "ModelOutput"]
    assert events[0]["request_id"] == events[1]["request_id"]
    assert events[1]["data"]["predictions"] == json.loads(body)["predictions"]
    assert "drained; exiting" in text
