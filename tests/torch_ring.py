"""Helpers of the ring-plane tests (``test_torch_ring.py``,
``test_torch_frontend.py``): one small bundle both packages load, a plane
booted as ``python -m mlops_tpu_torch serve`` (or, with a stub engine,
``tests/torch_ring_stub.py``) in a subprocess, and a raw-socket HTTP
client.

A plane never forks from the pytest process: its threads (JAX's among
them) make a fork unsafe, so every plane is a subprocess of its own.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4, precision="bf16")
BUCKETS = "1,8,64"


TEST_BUDGET_S = 180


@pytest.fixture(autouse=True)
def budget():
    """Each test's own time limit: SIGALRM fails a test that outlives
    TEST_BUDGET_S instead of letting it hang the run."""
    def expire(*_):
        raise TimeoutError(f"the test outlived its {TEST_BUDGET_S} s budget")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_BUDGET_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def make_bundle(root: Path, seed: int = 0, model: dict | None = None,
                quant: bool = True) -> Path:
    """A port-written flax bundle both packages load: an mlp (``model``:
    ``MODEL`` unless given) with flax-init weights plus noise, both from
    ``seed``, the preprocessor and monitor of 3,000 synthetic rows (the
    JAX package's fits), and with ``quant`` a gated quant student."""
    import jax

    from mlops_tpu.config import ModelConfig as JaxModelConfig
    from mlops_tpu.data import Preprocessor as JaxPreprocessor
    from mlops_tpu.data import generate_synthetic
    from mlops_tpu.models import build_model as jax_build_model
    from mlops_tpu.models import init_params as jax_init_params
    from mlops_tpu.monitor import state as jstate
    from mlops_tpu_torch.bundle import save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.data import Preprocessor
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
    from mlops_tpu_torch.weights import exact_params_from_numpy, load_params, monitor_from_numpy

    columns, _ = generate_synthetic(3000, seed=0)
    jprep = JaxPreprocessor.fit(columns)
    jmon = jstate.fit_monitor(jprep.encode(columns))
    jprep.save(root / "preprocess.npz")
    model_kw = dict(MODEL if model is None else model)
    params = jax_init_params(jax_build_model(JaxModelConfig(**model_kw)),
                             jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(100 + seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32), params)
    module = load_params(build_model(ModelConfig(**model_kw)),
                         exact_params_from_numpy(params, "cpu")).eval()
    path = root / "bundle"
    save_exact_bundle(
        path, ModelConfig(**model_kw), module, Preprocessor.load(root / "preprocess.npz"),
        monitor_from_numpy(jmon.to_arrays(), "cpu"), calibration={"temperature": 1.37},
        **(dict(quant_params=quantize_student(init_quant_master(seed)),
                quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}})
           if quant else {}),
    )
    return path


def records(n: int, seed: int, drift: float = 0.0) -> list[dict]:
    from mlops_tpu.data import generate_synthetic

    columns, _ = generate_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Plane:
    """A serving plane in a subprocess, on a free port, its output in a
    log file: ``python -m mlops_tpu_torch serve [--config <toml>]`` with
    ``overrides`` and ``env``, or with ``stub`` the stub-engine plane of
    ``tests/torch_ring_stub.py``. Stopped with SIGTERM (then SIGKILL)."""

    def __init__(self, bundle: Path, log: Path, overrides=(), env=None, stub=False,
                 timeout: float = 90, config: Path | None = None, wait: bool = True) -> None:
        self.port = free_port()
        self.log = log
        args = [f"serve.model_directory={bundle}", f"serve.port={self.port}",
                "serve.host=127.0.0.1", "serve.device=cpu",
                f"serve.warmup_batch_sizes={BUCKETS}", *overrides]
        cmd = ([sys.executable, str(ROOT / "tests" / "torch_ring_stub.py"), *args] if stub
               else [sys.executable, "-m", "mlops_tpu_torch", "serve",
                     *(["--config", str(config)] if config else []), *args])
        self._out = open(log, "wb")
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=self._out, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", **(env or {})),
        )
        if wait:  # else the caller overlaps the boot with its own work
            self.wait_ready(timeout)

    def wait_ready(self, timeout: float = 90) -> None:
        deadline = time.monotonic() + timeout
        while True:
            assert self.proc.poll() is None, f"plane exited: {self.text()[-3000:]}"
            try:
                if exchange(self.port, "GET", "/healthz/ready")[0] == 200:
                    return
            except OSError:
                pass
            assert time.monotonic() < deadline, f"plane never ready: {self.text()[-3000:]}"
            time.sleep(0.05)

    def text(self) -> str:
        return self.log.read_text(errors="replace")

    def pids(self) -> dict[str, int]:
        """The latest pid of each engine replica (``engine`` is replica
        0's, ``engine r`` replica r's) and of each front end."""
        out = {}
        for line in self.text().splitlines():
            if line.startswith("engine replica ") and " started (pid " in line:
                pid = int(line.split("pid ")[1].rstrip(")"))
                replica = int(line.split()[2])
                out[f"engine {replica}"] = pid
                if replica == 0:
                    out["engine"] = pid
            elif line.startswith("frontend ") and " started (pid " in line:
                out[f"frontend {line.split()[1]}"] = int(line.split("pid ")[1].rstrip(")"))
        return out

    def metric(self, name: str) -> float:
        text = exchange(self.port, "GET", "/metrics")[2].decode()
        for line in text.splitlines():
            if line.startswith(name):
                return float(line.rsplit(" ", 1)[1])
        raise AssertionError(f"no {name} in /metrics")

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._out.close()
        return self.proc.returncode


def _recv(sock_file):
    status_line = sock_file.readline()
    if not status_line:
        return None
    status = int(status_line.split(b" ")[1])
    headers = {}
    while True:
        line = sock_file.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers, sock_file.read(int(headers.get("content-length", 0)))


def exchange(port: int, method: str, path: str, body=None, headers=None,
             timeout: float = 30):
    """One request on its own connection: ``(status, headers, body)``."""
    data = b"" if body is None else (body if isinstance(body, bytes)
                                     else json.dumps(body).encode())
    head = [f"{method} {path} HTTP/1.1", "host: t", f"content-length: {len(data)}",
            *(f"{k}: {v}" for k, v in (headers or {}).items()), "connection: close"]
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        with sock.makefile("rb") as f:
            status, got_headers, payload = _recv(f)
    return status, got_headers, payload
