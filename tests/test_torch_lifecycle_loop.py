"""The port's closed lifecycle loop against the JAX package's, on the CPU:
the controller from drift to promotion, a candidate the gates reject,
the circuit breaker, and the loop as deployed — ``python -m
mlops_tpu_torch serve --config configs/lifecycle_serve.toml`` in a
subprocess with only the loop's clocks overridden, as
``scripts/lifecycle_smoke.py`` runs the JAX server: a hammer of requests,
normal then drifted, zero non-200 answers, generation 2 with a
promotion, and a clean drain on SIGTERM.

The incumbent is the JAX suite's (``tiny_pipeline``: mlp, hidden
(32, 32), embed 4, buckets (1, 8)); the controllers run on injected
clocks, ``run_once`` by ``run_once``, so the two packages' outcome
sequences are compared step for step.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.lifecycle import LifecycleController as JaxController
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.lifecycle import controller as controller_module
from mlops_tpu_torch.lifecycle.controller import LifecycleController
from mlops_tpu_torch.serve.engine import InferenceEngine
from torch_lifecycle import (  # noqa: F401
    budget,
    feed,
    jax_config,
    port_config,
    scenery,
    traffic,
)
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROOT = Path(__file__).resolve().parent.parent


def _engine(bundle):
    engine = InferenceEngine(bundle, buckets=(1, 8), device="cpu")
    engine.warmup()
    return engine


def _drive(ctrl, engine, normal, drifted, clock, ticks=6):
    """The JAX suite's drive: a normal baseline window, then drifted
    windows one tick apart; returns each ``run_once``'s outcome."""
    feed(engine, normal)
    steps = [ctrl.run_once()]
    for _ in range(ticks):
        feed(engine, drifted)
        clock["t"] += 1.0
        steps.append(ctrl.run_once())
        if sum(steps[-1]["promotions"].values()):
            break
    return [(s["state"], s["drift_triggers"], dict(s["promotions"]), s["generation"])
            for s in steps], steps[-1]


def _no_latency_gate(config):
    """The p99 gate reads wall-clock timings of four mirrors on a shared
    CPU (either package can fail it under a loaded test run); the two
    state machines are compared with it out of reach, and the gate itself
    is held against the JAX gate in ``test_torch_lifecycle_triggers.py``."""
    config.lifecycle.max_p99_ratio = 1e6
    return config


def test_drift_to_promotion_follows_the_jax_controller(scenery):
    clock = {"t": 0.0}
    engine = _engine(scenery["bundle"])
    ctrl = LifecycleController(
        engine, _no_latency_gate(port_config(scenery["td"] / "port", scenery["labeled"])),
        clock=lambda: clock["t"],
    )
    got, status = _drive(ctrl, engine, scenery["normal"], scenery["drifted"], clock)

    jclock = {"t": 0.0}
    jbundle = jax_load_bundle(scenery["bundle_dir"])
    jengine = JaxEngine(jbundle, buckets=(1, 8), enable_grouping=False)
    jengine.warmup()
    jctrl = JaxController(
        jengine, _no_latency_gate(jax_config(scenery["td"] / "jax", scenery["labeled"])),
        clock=lambda: jclock["t"],
    )
    jnormal, jdrifted = traffic(jbundle.preprocessor)
    want, jstatus = _drive(jctrl, jengine, jnormal, jdrifted, jclock)
    assert got == want
    assert got[-1] == ("idle", 1, {"promoted": 1, "rejected": 0, "rolled_back": 0}, 2)

    report = status["last_report"]
    assert report["gates"] == jstatus["last_report"]["gates"] == {"passed": True, "reasons": []}
    assert report["mirrors"] == jstatus["last_report"]["mirrors"]
    assert report["warm_mode"] == "eager" and jstatus["last_report"]["warm_mode"] == "shared"
    assert report["auc_delta"] > 0
    assert abs(report["auc_candidate"] - jstatus["last_report"]["auc_candidate"]) <= 0.01
    assert status["last_retrain"]["wall_s"] > 0
    snap, jsnap = ctrl.metrics_snapshot(), jctrl.metrics_snapshot()
    for key in ("reservoir_rows", "tee_drops", "breaker_open", "breaker_trips"):
        assert snap[key] == jsnap[key], key
    # One-call rollback, then a rollback of the rollback, as in JAX.
    assert ctrl.rollback() == jctrl.rollback() == 3
    assert ctrl.status()["promotions"] == jctrl.status()["promotions"]
    ctrl.stop()
    jctrl.stop()
    assert (scenery["td"] / "port" / "lifecycle" / "reservoir.npz").is_file()


def test_a_candidate_failing_the_auc_gate_never_swaps(scenery, monkeypatch):
    from mlops_tpu_torch.lifecycle.retrain import run_retrain

    config = port_config(scenery["td"] / "wrecked", scenery["labeled"])
    good = run_retrain(scenery["bundle"], config, generation=2)
    for p in good.bundle.model.parameters():
        p.data.zero_()
    monkeypatch.setattr(controller_module, "run_retrain", lambda *a, **k: good)
    engine = _engine(scenery["bundle"])
    clock = {"t": 0.0}
    ctrl = LifecycleController(engine, config, clock=lambda: clock["t"])
    _, status = _drive(ctrl, engine, scenery["normal"], scenery["drifted"], clock)
    assert status["drift_triggers"] == 1
    assert status["promotions"] == {"promoted": 0, "rejected": 1, "rolled_back": 0}
    assert engine.bundle_generation == 1
    assert any(r.startswith("auc") for r in status["last_report"]["gates"]["reasons"])
    # A drift spike inside the post-rejection cooldown does not retrain.
    config.lifecycle.cooldown_s = 1000.0
    ctrl.policy.start_cooldown(clock["t"])
    feed(engine, scenery["drifted"])
    clock["t"] += 1.0
    assert ctrl.run_once()["drift_triggers"] == 1
    ctrl.stop()


def test_the_circuit_breaker_opens_on_repeated_retrain_failures(scenery, monkeypatch):
    from mlops_tpu_torch.serve.metrics import lifecycle_lines

    def broken(*args, **kwargs):
        raise RuntimeError("retrain failure")

    monkeypatch.setattr(controller_module, "run_retrain", broken)
    config = port_config(scenery["td"] / "breaker", scenery["labeled"])
    lc = config.lifecycle
    lc.hysteresis_windows, lc.breaker_failures, lc.breaker_cooldown_s = 1, 2, 100.0
    engine = _engine(scenery["bundle"])
    clock = {"t": 0.0}
    ctrl = LifecycleController(engine, config, clock=lambda: clock["t"])
    feed(engine, scenery["normal"])
    ctrl.run_once()
    for expected in (1, 2):
        feed(engine, scenery["drifted"])
        clock["t"] += 1.0
        status = ctrl.run_once()
        assert status["drift_triggers"] == expected and status["state"] == "idle"
        assert "retrain failure" in status["last_error"]
    assert status["breaker_open"] is True and status["breaker_trips"] == 1
    observed = []
    real_observe = ctrl.policy.observe
    ctrl.policy.observe = lambda *a, **k: (observed.append(1), real_observe(*a, **k))[1]
    for _ in range(3):
        feed(engine, scenery["drifted"])
        clock["t"] += 1.0
        status = ctrl.run_once()
    ctrl.policy.observe = real_observe
    assert observed == [] and status["drift_triggers"] == 2
    lines = "\n".join(lifecycle_lines(ctrl.metrics_snapshot()))
    assert 'mlops_tpu_lifecycle_breaker_open{tenant="default"} 1' in lines
    assert 'mlops_tpu_lifecycle_breaker_trips_total{tenant="default"} 1' in lines
    clock["t"] += 101.0
    feed(engine, scenery["drifted"])
    clock["t"] += 1.0
    status = ctrl.run_once()
    assert status["breaker_open"] is False and status["drift_triggers"] == 3
    assert (status["breaker_trips"], status["consecutive_failures"]) == (1, 1)
    ctrl.stop()


# ------------------------------------------------------- the live server
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _metric(text: str, name: str, labels: str) -> float | None:
    match = re.search(re.escape(f"{name}{{{labels}}}") + r" ([-0-9.e+]+)", text)
    return float(match.group(1)) if match else None


def _records(columns, n, offset=0):
    return [{k: columns[k][offset + i] for k in columns} for i in range(n)]


def test_the_deployed_loop_swaps_under_traffic_with_no_error(scenery, tmp_path):
    """``serve --config configs/lifecycle_serve.toml`` as
    ``scripts/lifecycle_smoke.py`` drives the JAX server."""
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.schema.features import SCHEMA

    columns, _ = generate_synthetic(32, seed=3)
    drifted = {k: list(v) for k, v in columns.items()}
    for feat in SCHEMA.numeric:
        drifted[feat.name] = [v * 10.0 for v in drifted[feat.name]]
    bodies = {False: json.dumps(_records(columns, 8)).encode(),
              True: json.dumps(_records(drifted, 8, offset=16)).encode()}
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               MODEL_DIRECTORY=str(scenery["bundle_dir"]))
    server = subprocess.Popen(
        [sys.executable, "-m", "mlops_tpu_torch", "serve",
         "--config", str(ROOT / "configs/lifecycle_serve.toml"),
         "serve.device=cpu", "serve.host=127.0.0.1", f"serve.port={port}",
         "serve.warmup_batch_sizes=1,8", "serve.max_batch=8",
         "serve.batch_window_ms=0", "serve.monitor_fetch_every_s=0.5",
         f"lifecycle.dir={tmp_path / 'lifecycle'}",
         f"lifecycle.labeled_path={scenery['labeled']}",
         "lifecycle.retrain_steps=50", "lifecycle.min_labeled_rows=500",
         "lifecycle.min_window_rows=32", "lifecycle.cooldown_s=2",
         "lifecycle.tick_s=0.25", "lifecycle.mirror_fraction=1.0",
         "lifecycle.shadow_min_mirrors=4", "lifecycle.max_ece=0.3"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log: list[str] = []
    pump = threading.Thread(target=lambda: log.extend(iter(server.stdout.readline, "")),
                            daemon=True)
    pump.start()
    counts = {"ok": 0, "bad": []}
    phase = {"drift": False}
    stop = threading.Event()
    base = f"http://127.0.0.1:{port}"

    def hammer():
        while not stop.is_set():
            req = urllib.request.Request(f"{base}/predict", data=bodies[phase["drift"]],
                                         headers={"content-type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    resp.read()
                    status = resp.status
            except urllib.error.HTTPError as err:
                status = err.code
            except OSError as err:
                status = repr(err)
            if status == 200:
                counts["ok"] += 1
            else:
                counts["bad"].append(status)

    def scrape():
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            return resp.read().decode()

    def wait_for(name, labels, minimum, seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            assert server.poll() is None, "".join(log[-40:])
            value = _metric(scrape(), name, labels)
            if value is not None and value >= minimum:
                return value
            time.sleep(0.25)
        raise AssertionError(f"{name}{{{labels}}} never reached {minimum}: "
                             + "".join(log[-40:]))

    client = threading.Thread(target=hammer, daemon=True)
    try:
        deadline = time.monotonic() + 30
        while True:
            assert server.poll() is None and time.monotonic() < deadline, "".join(log)
            try:
                with urllib.request.urlopen(f"{base}/healthz/ready", timeout=2) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        client.start()
        time.sleep(1.5)
        text = scrape()
        assert _metric(text, "mlops_tpu_bundle_generation", 'tenant="default"') == 1
        assert _metric(text, "mlops_tpu_drift_trigger_total", 'tenant="default"') == 0
        phase["drift"] = True
        wait_for("mlops_tpu_drift_trigger_total", 'tenant="default"', 1, 20)
        # A rejection (the p99 gate reads timings on a shared CPU) cools
        # down for 2 s and the next trigger retrains again: room for two.
        wait_for("mlops_tpu_promotions_total", 'tenant="default",outcome="promoted"', 1, 45)
        assert wait_for("mlops_tpu_bundle_generation", 'tenant="default"', 2, 5) == 2
        time.sleep(0.5)  # traffic on the promoted bundle
        stop.set()
        client.join(timeout=30)
        assert counts["ok"] > 0 and counts["bad"] == [], counts["bad"][:5]
        server.send_signal(signal.SIGTERM)
        assert server.wait(timeout=30) == 0, "".join(log[-40:])
        pump.join(timeout=5)
        text = "".join(log)
        assert "lifecycle controller started" in text and "candidate promoted" in text
        assert "Task was destroyed" not in text
        assert (tmp_path / "lifecycle" / "reservoir.npz").is_file()
    finally:
        stop.set()
        if server.poll() is None:
            server.kill()
            server.wait(timeout=10)
