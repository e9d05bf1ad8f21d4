"""The SLO layer on the port (``mlops_tpu_torch/slo/``: the SLO engine,
the cost ledger, the flight recorder; their series on both planes, the
``/healthz`` verdict, ``flightrec``, ``/debug/profile`` over the ring)
against the JAX package, on the CPU.

- Unit traces: both packages' ``SLOEngine`` fed the same cumulative
  counters on the same clock (burn rates within 1e-12, alert flags, the
  alert callbacks, the rendered block and the verdict exact, respawn seeds
  included); the shared-memory rows written by either read by the other;
  ``CostLedger`` snapshots, tables, files and reports equal, each
  package's ledger file loaded by the other, the model tag the JAX
  fingerprint's; ``FlightRecorder`` dumps with the same events (but their
  clocks and pid), the spike trigger, retention and ``format_timeline``
  equal, ``flightrec`` printing what the JAX command prints; the config's
  validation messages equal; the ring's rows rendered as the JAX ring
  render renders them.
- End to end: each package's single-process server with a seeded fault
  plan (the first four dispatches raise) raises the same alerts, answers
  the same ``/healthz`` verdict, dumps its flight recorder on the alert,
  and answers the profile routes without a ``serve.profile_dir`` (404) the
  same way. The port's ring plane (a subprocess: two front ends, two
  replicas, the plan through ``MLOPS_TPU_FAULTS``) raises the alert from
  the lead replica's rows, answers ``/healthz`` degraded, dumps on the
  alert's edge, forwards ``/debug/profile`` to replica 0 with the answers
  the JAX profiler gives (200 / 409 / 200 / 409), and keeps the cost
  ledger's counts across a kill -9 of replica 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest

from mlops_tpu import faults as jax_faults
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.compilecache.keys import model_fingerprint
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import ServeConfig as JaxServeConfig
from mlops_tpu.config import SLOConfig as JaxSLOConfig
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.serve.ipc import RequestRing as JaxRing
from mlops_tpu.serve.metrics import ROB_DEGRADED
from mlops_tpu.serve.metrics import render_ring_metrics as jax_render_ring_metrics
from mlops_tpu.serve.server import HttpServer as JaxHttpServer
from mlops_tpu.serve.server import JaxProfiler
from mlops_tpu.slo import engine as jax_slo
from mlops_tpu.slo import flightrec as jax_flightrec
from mlops_tpu.slo import ledger as jax_ledger
from mlops_tpu.trace.shapes import ShapeStats as JaxShapeStats
from mlops_tpu_torch import faults
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig, ServeConfig, SLOConfig
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.ipc import RequestRing
from mlops_tpu_torch.serve.metrics import ENG_DEGRADED, render_ring_metrics
from mlops_tpu_torch.serve.server import HttpServer, TorchProfiler, arm_observability
from mlops_tpu_torch.slo import engine as slo
from mlops_tpu_torch.slo import flightrec, ledger
from mlops_tpu_torch.trace.shapes import ShapeStats
from torch_observe import (
    OBSERVABILITY_FAMILIES,
    LoopServer,
    arm_jax,
    jax_slo_engine,
    metric,
    observability_labels,
)
from torch_ring import Plane, budget, exchange, make_bundle, records  # noqa: F401

WINDOWS = dict(fast_short_s=60.0, fast_long_s=120.0, slow_short_s=180.0, slow_long_s=240.0)


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("slo"))


def _configs(**kw):
    return SLOConfig(enabled=True, **kw).validate(), JaxSLOConfig(enabled=True, **kw).validate()


# ------------------------------------------------------------ SLO engine
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_slo_engine_burns_and_alerts_as_jax(seed):
    """Seeded cumulative counters per tenant on a 0.5 s clock, bursts of
    failures and slow requests among them, a breaker that opens and
    closes, and (seed 2) a respawn seed."""
    rng = np.random.default_rng(seed)
    tenants = ("default", "apac")[: 1 + seed % 2]
    port_cfg, jax_cfg = _configs(fast_short_s=2.0, fast_long_s=5.0, slow_short_s=8.0,
                                 slow_long_s=12.0, tick_s=0.5)
    counts = {t: np.zeros(4, np.int64) for t in tenants}
    breaker = {t: False for t in tenants}
    prior = ({t: (7, 9, 8, 9) for t in tenants} if seed == 2 else None)
    fired: dict[str, list] = {"port": [], "jax": []}
    engines = {}
    for name, mod, cfg in (("port", slo, port_cfg), ("jax", jax_slo, jax_cfg)):
        engines[name] = mod.SLOEngine(
            cfg, tenants, source=lambda: {t: tuple(int(x) for x in c) for t, c in counts.items()},
            breaker_source=lambda: dict(breaker), prior_counts=prior,
            on_alert=lambda a, t, s, out=fired[name]: out.append((a, t, s)))
    for step in range(60):
        now = 100.0 + 0.5 * step
        for t in tenants:
            n = int(rng.integers(0, 40))
            bad = int(rng.binomial(n, 0.3 if 15 <= step < 25 else 0.0005))
            slow = int(rng.binomial(n, 0.2 if 35 <= step < 40 else 0.001))
            counts[t] += (n - bad, n, n - slow, n)
            breaker[t] = 45 <= step < 50 and t == tenants[-1]
        for engine in engines.values():
            engine.tick(now=now)
        got, want = engines["port"].view(), engines["jax"].view()
        assert got.keys() == want.keys()
        for t in tenants:
            assert got[t]["alerts"] == want[t]["alerts"]
            for name in slo.SLO_NAMES:
                g, w = got[t]["slos"][name], want[t]["slos"][name]
                assert (g["good"], g["total"], g["budget_pct"]) == (
                    w["good"], w["total"], w["budget_pct"])
                assert g["burn"].keys() == w["burn"].keys()
                for label in g["burn"]:
                    assert abs(g["burn"][label] - w["burn"][label]) <= 1e-12
        assert engines["port"].any_alert_active() == engines["jax"].any_alert_active()
        assert engines["port"].render_lines() == engines["jax"].render_lines()
        assert (engines["port"].render_lines(engine_down=True)
                == engines["jax"].render_lines(engine_down=True))
        for ready, down in ((True, False), (False, False), (True, True)):
            assert slo.health_verdict(got, ready, down) == jax_slo.health_verdict(want, ready, down)
    assert fired["port"] == fired["jax"] and fired["port"]
    assert {a for a, _, _ in fired["port"]} >= {"availability_fast_burn", "lifecycle_breaker"}
    assert slo.ENGINE_ALERTS == jax_slo.ENGINE_ALERTS
    assert slo.ALERT_SEVERITY == jax_slo.ALERT_SEVERITY
    assert (slo.SLO_NAMES, slo.SLO_FIELDS) == (jax_slo.SLO_NAMES, jax_slo.SLO_FIELDS)
    # The shared-memory rows: written by either, read by the other.
    rows = {}
    for name, engine in engines.items():
        vals = np.zeros((len(tenants), slo.SLO_FIELDS))
        alerts = np.zeros((len(tenants), slo.N_ENGINE_ALERTS))
        engine.write_rows(vals, alerts)
        rows[name] = (vals, alerts)
    np.testing.assert_array_equal(rows["port"][0], rows["jax"][0])
    np.testing.assert_array_equal(rows["port"][1], rows["jax"][1])
    windows = engines["port"].windows
    assert (slo.read_slo_view(*rows["jax"], tenants, windows)
            == jax_slo.read_slo_view(*rows["port"], tenants, windows))


@pytest.mark.parametrize("bad", [
    dict(availability_target=1.0), dict(latency_threshold_ms=5000.0), dict(tick_s=0.0),
    dict(fast_short_s=90.0, fast_long_s=90.5), dict(slow_short_s=9.0, slow_long_s=3.0),
    dict(flightrec_keep=0, flightrec_spike_window_s=0.0), dict(ledger_flush_s=-1.0),
])
def test_the_slo_config_refuses_as_jax(bad):
    with pytest.raises(ValueError) as port_err:
        SLOConfig(**bad).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxSLOConfig(**bad).validate()
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------ cost ledger
def _ledger_traffic(seed: int):
    rng = np.random.default_rng(seed)
    entries = ("bucket_1", "bucket_8@quant", "group_4x1", "group_64x8")
    for _ in range(120):
        padded = int(rng.integers(1, 65))
        yield (entries[int(rng.integers(0, 4))], ("0a3426a7", "511a067f")[int(rng.integers(0, 2))],
               int(rng.integers(1, padded + 1)), padded, float(rng.random()) * 1e-3)


def test_the_cost_ledger_is_jax(tmp_path):
    port = ledger.CostLedger(tmp_path / "port", flush_interval_s=60.0)
    jax = jax_ledger.CostLedger(tmp_path / "jax", flush_interval_s=60.0)
    for obs in _ledger_traffic(0):
        port.observe(*obs)
        jax.observe(*obs)
    assert port.snapshot() == jax.snapshot()
    assert port.render_lines() == jax.render_lines()
    tables = []
    for led in (port, jax):
        keys = np.zeros((ledger.TABLE_ROWS, ledger.TABLE_KEY_BYTES), np.uint8)
        vals = np.zeros((ledger.TABLE_ROWS, ledger.TABLE_VALS))
        led.write_table(keys, vals)
        tables.append((keys, vals))
    np.testing.assert_array_equal(tables[0][0], tables[1][0])
    np.testing.assert_array_equal(tables[0][1], tables[1][1])
    read = ledger.read_table(*tables[0])
    assert read == jax_ledger.read_table(*tables[1])
    assert ledger.merge_entries([read, read]) == jax_ledger.merge_entries([read, read])
    port.close()
    jax.close()
    assert (json.loads((tmp_path / "port/ledger.json").read_text())["entries"]
            == json.loads((tmp_path / "jax/ledger.json").read_text())["entries"])
    # Each package's file accumulates in the other's ledger, and one
    # report reads both shards.
    again = jax_ledger.CostLedger(tmp_path / "port", flush_interval_s=60.0)
    again_port = ledger.CostLedger(tmp_path / "jax", flush_interval_s=60.0)
    assert again.snapshot() == again_port.snapshot()  # the files' 6-place seconds
    assert again.snapshot().keys() == port.snapshot().keys()
    again.close()
    again_port.close()
    shard = tmp_path / "shards"
    for i, cls in enumerate((ledger.CostLedger, jax_ledger.CostLedger)):
        led = cls(shard, shard=f"r{i}")
        for obs in _ledger_traffic(1 + i):
            led.observe(*obs)
        led.close()
    assert ledger.ledger_report(shard) == jax_ledger.ledger_report(shard)
    assert (ledger.format_ledger_report(ledger.ledger_report(shard))
            == jax_ledger.format_ledger_report(jax_ledger.ledger_report(shard)))


@pytest.mark.parametrize("model", [
    {}, dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4, precision="bf16"),
    dict(family="mlp", ensemble_size=8, hidden_dims=(256, 256, 128), embed_dim=16),
])
def test_the_ledger_model_tag_is_the_jax_fingerprint(model):
    assert ledger.model_tag(ModelConfig(**model)) == model_fingerprint(JaxModelConfig(**model))[:8]


# -------------------------------------------------------- flight recorder
def _feed(recorder, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(30):
        status = (200, 200, 200, 500, 503, 404, 504)[int(rng.integers(0, 7))]
        recorder.observe_request(("/predict", "/healthz/ready")[i % 5 == 4], status,
                                 float(rng.random()) * 20, tenant=("default", "apac")[i % 2],
                                 request_id=f"id{i}" if i % 3 else "")
        if i % 4 == 0:
            recorder.note_span({"kind": "span", "trace_id": f"t{i}", "status": status,
                                "entry": "bucket_8", "wall_ms": 3.5,
                                "stages": {"admission": 0.2, "dispatch": 2.1, "respond": 1.2}})
        if i == 20:
            recorder.note_alert("availability_fast_burn", "default", "page")
        if i == 25:
            recorder.note("respawn", replica=1, incarnation=2)


def _strip(dump: dict) -> dict:
    out = {k: v for k, v in dump.items() if k not in ("ts", "t", "pid")}
    out["events"] = [{k: v for k, v in e.items() if k not in ("ts", "t")} for e in dump["events"]]
    return out


def test_the_flight_recorder_dumps_as_jax(tmp_path, capsys):
    dumps = {}
    for name, mod in (("port", flightrec), ("jax", jax_flightrec)):
        rec = mod.FlightRecorder(tmp_path / name, capacity=40, cooldown_s=3600.0, keep=2,
                                 spike_errors=3, spike_window_s=60.0, source="ring", worker=1)
        _feed(rec, 0)
        time.sleep(0.2)  # the spike's dump runs on its own thread
        deadline = time.monotonic() + 10
        while rec.landed < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert (rec.dumps, rec.landed) == (1, 1)  # the cooldown held every later trigger
        assert rec.suppressed > 0
        assert rec.dump_if_evidence("sigterm") is not None
        rec.dump("fatal")
        files = sorted((tmp_path / name).glob("flightrec-*.json"))
        assert len(files) == 2  # retention: the newest two
        dumps[name] = [mod.load_dump(f) for f in files]
        assert [d["reason"] for d in dumps[name]] == ["sigterm", "fatal"]
    assert [_strip(d) for d in dumps["port"]] == [_strip(d) for d in dumps["jax"]]
    for dump in dumps["port"]:
        assert flightrec.format_timeline(dump) == jax_flightrec.format_timeline(dump)
    paths = [str(p) for p in sorted((tmp_path / "port").glob("flightrec-*.json"))]
    paths.append(str(tmp_path / "missing.json"))
    assert main(["flightrec", *paths]) == 0
    got = capsys.readouterr()
    assert jax_main(["flightrec", *paths]) == 0
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    # A clean ring writes nothing on SIGTERM.
    quiet = flightrec.FlightRecorder(tmp_path / "quiet")
    quiet.observe_request("/predict", 200, 1.0)
    assert quiet.dump_if_evidence("sigterm") is None
    assert not (tmp_path / "quiet").exists()


# --------------------------------------------------------- the ring rows
def test_the_ring_rows_render_as_the_jax_ring_render(tmp_path):
    kw = dict(workers=2, slots_small=2, slots_large=1, large_rows=8,
              tenant_names=("default", "apac"), replicas=2)
    ring, jring = RequestRing(**kw), JaxRing(**kw)
    try:
        port_cfg, jax_cfg = _configs(**WINDOWS)
        ring.arm_slo(port_cfg)
        jring.arm_slo(jax_cfg)
        np.testing.assert_array_equal(ring.slo_meta, jring.slo_meta)
        rng = np.random.default_rng(3)
        for name in ("req_counts", "lat_counts", "lat_n", "pred_lat_counts", "pred_lat_n",
                     "trace_dropped", "flight_dumps"):
            values = rng.integers(0, 9, getattr(ring, name).shape)
            getattr(ring, name)[...] = values
            getattr(jring, name)[...] = values
        assert ring.slo_counts(50.0) == jring.slo_counts(50.0)
        counts = ring.slo_counts(50.0)
        for mod, target, cfg, stats_cls, led_mod in (
                (slo, ring, port_cfg, ShapeStats, ledger),
                (jax_slo, jring, jax_cfg, JaxShapeStats, jax_ledger)):
            engine = mod.SLOEngine(cfg, target.tenant_names, source=lambda: counts)
            engine.write_rows(target.slo_vals, target.alert_vals)
            for r in range(2):
                stats = stats_cls()
                stats.t0 = 1.0
                led = led_mod.CostLedger(tmp_path / f"{led_mod.__name__}{r}")
                for entry, tag, req, pad, sec in _ledger_traffic(10 + r):
                    stats.observe(entry, req, pad)
                    led.observe(entry, tag, req, pad, sec)
                stats.write_table(target.shape_keys[r], target.shape_vals[r])
                target.shape_meta[r] = stats.t0
                led.write_table(target.ledger_keys[r], target.ledger_vals[r])
                target.ledger_meta[r] = 1.0
                led.close()
        ring.eng_vals[:, ENG_DEGRADED] = jring.rob_vals[:, ROB_DEGRADED] = (2.0, 3.0)
        for down in (False, True):
            if down:  # a full outage the supervisor stamped
                for target in (ring, jring):
                    target.set_ready(False)
                    target.eng_vals[:, 1] = 5.0
            text, jtext = render_ring_metrics(ring), jax_render_ring_metrics(jring)

            def block(t):
                return [ln for ln in t.splitlines()
                        if any(f in ln for f in OBSERVABILITY_FAMILIES)
                        and "useful_rows_per_s " not in ln]

            assert block(text) == block(jtext)
            assert observability_labels(text) == observability_labels(jtext)
            assert (f'mlops_tpu_alert_active{{alert="engine_down",severity="page",'
                    f'tenant="apac"}} {int(down)}') in text
    finally:
        ring.close()
        jring.close()


# ----------------------------------------------------------- end to end
def test_the_single_planes_burn_and_answer_as_jax(bundle_dir, tmp_path):
    cfg = dict(**WINDOWS, latency_threshold_ms=1000.0, tick_s=0.2)
    jax_engine = JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8, 64))
    jax_engine.ready = True
    jax_server = JaxHttpServer(jax_engine, JaxServeConfig(
        host="127.0.0.1", port=0, batch_window_ms=0.0).validate())
    jax_cfg = JaxSLOConfig(enabled=True, flightrec_dir=str(tmp_path / "jax-runs"), **cfg)
    arm_jax(jax_server, slo=jax_cfg)
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu")
    engine.warmup()
    port_server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0, batch_window_ms=0.0))
    port_cfg = SLOConfig(enabled=True, flightrec_dir=str(tmp_path / "port-runs"), **cfg)
    servers = {"jax": LoopServer(jax_server)}
    try:
        warm = [json.dumps(records(n, seed=70 + n)).encode() for n in (1, 3)]
        for body in warm:  # the JAX engine compiles its two shapes here
            assert servers["jax"].request("POST", "/predict", body)[0] == 200
        jax_server.slo_engine = jax_slo_engine(jax_server, jax_cfg)
        arm_observability(port_server, slo=port_cfg)
        servers["port"] = LoopServer(port_server)
        answers, texts, verdicts, profile = {}, {}, {}, {}
        for name, module in (("jax", jax_faults), ("port", faults)):
            module.arm(module.FaultPlan.from_rules(
                [{"point": "serve.engine.dispatch", "mode": "raise", "max_fires": 4}], seed=3))
            try:
                answers[name] = [servers[name].request("POST", "/predict", warm[i % 2])[0]
                                 for i in range(10)]
            finally:
                module.disarm()
            texts[name] = servers[name].request("GET", "/metrics")[1].decode()
            verdicts[name] = servers[name].request("GET", "/healthz")
            profile[name] = [servers[name].request("POST", f"/debug/profile/{action}")
                             for action in ("start", "start", "stop", "stop", "bogus")]
    finally:
        for server in servers.values():
            server.stop()
    assert answers["port"] == answers["jax"] == [500] * 4 + [200] * 6
    assert verdicts["port"] == verdicts["jax"]
    assert json.loads(verdicts["port"][1])["verdict"] == "degraded"

    def alerts(text):
        return sorted(ln for ln in text.splitlines() if ln.startswith("mlops_tpu_alert_active"))

    assert alerts(texts["port"]) == alerts(texts["jax"])
    assert 'availability_fast_burn",severity="page",tenant="default"} 1' in texts["port"]
    for kind, good in (("availability", 6), ("latency", 10)):
        for name, want in (("slo_good_total", good), ("slo_total", 10)):
            sample = f'mlops_tpu_{name}{{slo="{kind}",tenant="default"}}'
            assert metric(texts["port"], sample) == metric(texts["jax"], sample) == want
    assert observability_labels(texts["port"]) == observability_labels(texts["jax"])
    # Without serve.profile_dir both answer the routes 404 (a profiler
    # running beside the JAX one in this process is the ring test's, in
    # the plane's own process).
    assert profile["port"] == profile["jax"]
    assert [s for s, _ in profile["port"]] == [404] * 5
    assert TorchProfiler("").control("start") == JaxProfiler("").control("start") == (404, None)
    for name in ("jax", "port"):
        deadline = time.monotonic() + 10  # the alert's dump runs on its own thread
        while not (dumps := sorted((tmp_path / f"{name}-runs").glob("flightrec-*.json"))):
            assert time.monotonic() < deadline, f"{name}: no dump on the alert"
            time.sleep(0.05)
        assert [jax_flightrec.load_dump(d)["reason"] for d in dumps] == [
            "alert-availability_fast_burn"]


PLAN = """\
seed = 5
[[fault]]
point = "serve.engine.dispatch"
mode = "raise"
max_fires = 3
"""


def test_the_ring_plane_burns_dumps_profiles_and_keeps_its_ledger(bundle_dir, tmp_path, capsys):
    plan = tmp_path / "plan.toml"
    plan.write_text(PLAN)
    runs, led, prof = tmp_path / "runs", tmp_path / "ledger", tmp_path / "prof"
    plane = Plane(bundle_dir, tmp_path / "plane.log", env={"MLOPS_TPU_FAULTS": str(plan)},
                  overrides=(
                      "serve.workers=2", "serve.engine_replicas=2", "slo.enabled=true",
                      *(f"slo.{k}={v}" for k, v in WINDOWS.items()), "slo.tick_s=0.1",
                      f"slo.flightrec_dir={runs}", f"slo.ledger_dir={led}",
                      "slo.ledger_flush_s=0.2", f"serve.profile_dir={prof}"))
    try:
        body = json.dumps(records(2, seed=80)).encode()
        statuses = [exchange(plane.port, "POST", "/predict", body)[0] for _ in range(10)]
        # Sequential requests route to replica 0 (least loaded, lowest
        # index), whose first three dispatches raise.
        assert statuses == [500] * 3 + [200] * 7
        deadline = time.monotonic() + 20
        sample = ('mlops_tpu_alert_active{alert="availability_fast_burn",severity="page",'
                  'tenant="default"}')
        while metric(exchange(plane.port, "GET", "/metrics")[2].decode(), sample) != 1:
            assert time.monotonic() < deadline, "the lead replica never raised the alert"
            time.sleep(0.05)
        status, _, payload = exchange(plane.port, "GET", "/healthz")
        verdict = json.loads(payload)
        assert (status, verdict["verdict"], verdict["ready"]) == (200, "degraded", True)
        assert {"alert": "availability_fast_burn", "tenant": "default",
                "severity": "page"} in verdict["alerts"]
        while not list(runs.glob("flightrec-*-alert-availability_fast_burn.json")):
            assert time.monotonic() < deadline, "no front end dumped on the alert"
            time.sleep(0.05)
        dumps = sorted(str(p) for p in runs.glob("flightrec-*.json"))
        assert main(["flightrec", *dumps]) == 0
        got = capsys.readouterr()
        assert jax_main(["flightrec", *dumps]) == 0
        assert (got.out, got.err) == tuple(capsys.readouterr())[:2]
        assert all(d["source"] == "ring" for d in json.loads(got.out))
        actions = ("start", "start", "stop", "stop")
        answers = [exchange(plane.port, "POST", f"/debug/profile/{a}") for a in actions]
        jax_profiler = JaxProfiler(str(tmp_path / "jax-prof"))
        from mlops_tpu.serve.httpcore import profile_payload as jax_profile_payload

        want = [jax_profile_payload(jax_profiler.control(a)[0], a, str(prof))[:2]
                for a in actions]
        assert [(s, json.loads(b)) for s, _, b in answers] == want
        assert [s for s, _ in want] == [200, 409, 200, 409]
        assert list(prof.glob("*.pt.trace.json"))
        # The cost ledger across a kill -9 of replica 0: the respawn loads
        # its shard, so the fleet's counts carry on.
        time.sleep(0.6)  # a flush after the last dispatch
        before = _entry_dispatches(exchange(plane.port, "GET", "/metrics")[2].decode())
        assert before == 7
        shard = json.loads((led / "ledger-r0.json").read_text())["entries"]
        assert sum(v["dispatches"] for v in shard.values()) == 7
        os.kill(plane.pids()["engine 0"], signal.SIGKILL)
        while True:
            text = exchange(plane.port, "GET", "/metrics")[2].decode()
            if (metric(text, 'mlops_tpu_replica_incarnation{replica="0"}') == 2
                    and metric(text, 'mlops_tpu_replica_ready{replica="0"}') == 1):
                break
            assert time.monotonic() < deadline + 30, "replica 0 never came back"
            time.sleep(0.05)
        assert _entry_dispatches(text) == 7  # carried, not restarted
        served = sum(exchange(plane.port, "POST", "/predict", body)[0] == 200
                     for _ in range(5))  # the respawn's own first three raise
        assert served == 2
        time.sleep(0.5)
        assert _entry_dispatches(exchange(plane.port, "GET", "/metrics")[2].decode()) == 9
    finally:
        assert plane.stop() == 0
    assert "fault injection ARMED" in plane.text()
    # The respawn's own failures are evidence: the drain dumps it.
    assert list(runs.glob("flightrec-*-sigterm.json"))


def _entry_dispatches(text: str) -> int:
    return int(sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                   if line.startswith("mlops_tpu_entry_dispatch_total{")))


def test_unknown_routes_bill_other_as_jax():
    """ROADMAP C7: the single-process server billed an unknown path under
    its own text (an unbounded label); the JAX server bills ``<other>``."""
    from mlops_tpu.serve.metrics import ServingMetrics

    from mlops_tpu_torch.serve.server import Metrics

    port, jax = Metrics(), ServingMetrics()
    for route, status in (("/predict", 200), ("/nope", 404), ("/debug/profile/start", 404),
                          ("/docs/plain", 200), ("/metrics", 200)):
        port.observe_request(route, status)
        jax.observe_request(route, status, 0.0)

    def requests(text):
        return [ln for ln in text.splitlines() if ln.startswith("mlops_tpu_requests_total{")]

    assert requests(port.render({})) == requests(jax.render())


def test_a_disarmed_port_server_carries_no_observability_hook(bundle_dir):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    server = HttpServer(engine, ServeConfig())
    tracer, led = arm_observability(server, None, SLOConfig())
    assert (tracer, led, server.tracer, server.flightrec, server.slo_engine,
            server.cost_ledger, engine.shape_stats, engine.cost_ledger) == (None,) * 8
    server.close()
    assert dataclasses.asdict(SLOConfig()) == dataclasses.asdict(JaxSLOConfig())
