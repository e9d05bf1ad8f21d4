#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on an NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card of compute capability 9.0 and exits non-zero,
printing no result, without one (or when run from a directory that holds
this script and nothing else of the repository). It imports torch and the
port (``mlops_tpu_torch``), never JAX or the JAX package. Phases, each of
which fails the run loudly:

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions,
   compute capability;
2. build the fused quant-predict kernel from ``mlops_tpu_torch/csrc``
   with nvcc, printing the build time and ptxas' register/shared-memory
   summary;
3. a full-width quant bundle without JAX: 20,000 synthetic rows, the
   preprocessor and monitor fits (R=2048), seeded int8/bf16 student
   weights (E=4, H=32), written in the bundle format;
4. the kernel against its plain PyTorch version on the card, at solo
   buckets 1/8/64/256 with partial masks and at all 12 group geometries
   with all-padding slots: counts and K-S statistics exact, predictions
   within 1e-6, flags exact except rows within 1e-5 x threshold of it;
5. the main path: ``python -m mlops_tpu_torch serve`` in a subprocess
   answers the golden request and 5/64/256-record bodies (257 -> 413,
   malformed -> 422), the engine's grouped path runs a 64x1 and a 64x8
   group in this process; responses agree with the plain version run on
   the CPU, /metrics rows equal the records sent, the kernel's launch
   count rose, and SIGTERM drains the server;
6. timing with CUDA events at bucket 1, bucket 256 and groups 64x1 and
   64x8: kernel, plain version, whole dispatch -> fetch, and the bound
   from bytes and operations.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PRED_ATOL = 1e-6  # f32 MLP in another summation order + sigmoid
DRIFT_ATOL = 1e-5  # chi2/K-S p-values computed on two devices
FLAG_BAND = 1e-5  # flags may differ only within this fraction of the threshold


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    cap = torch.cuda.get_device_capability(0)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {cap}"
    )
    check(cap == (9, 0), f"need compute capability 9.0, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card_line


# ------------------------------------------------------------------ phase 2
def phase_build():
    from mlops_tpu_torch.ops import quant_kernel
    from mlops_tpu_torch.ops.cuda_build import build_shared_library

    result = build_shared_library(quant_kernel.KERNEL_SOURCE, "quant_fused")
    log(
        f"build: {result.path.name} in {result.seconds:.2f} s"
        + (" (reused)" if result.reused else "")
    )
    for line in result.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    quant_kernel.load_library()


# ------------------------------------------------------------------ phase 3
def phase_bundle(seed: int = 0) -> Path:
    from mlops_tpu_torch.bundle import save_quant_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=2048)
    qparams = quantize_student(init_quant_master(seed))
    directory = WORK / "bundle"
    shutil.rmtree(directory, ignore_errors=True)
    save_quant_bundle(
        directory, prep, monitor, qparams, temperature=1.0,
        gates={
            "passed": True,
            "note": "seeded weights, not distilled: this bundle checks "
            "parity, not quality",
        },
        tags={"source": "chip_smoke.py"},
    )
    log(f"bundle: {directory} (R={monitor.num_ref_sorted.shape[1]})")
    return directory


# ------------------------------------------------------------------ phase 4
def _records(n: int, seed: int, drift: float = 0.0) -> list[dict]:
    from mlops_tpu_torch.data import generate_synthetic

    columns, _ = generate_synthetic(n, seed=seed, drift=drift)
    names = list(columns)
    return [{k: columns[k][i] for k in names} for i in range(n)]


def _core_args(state, cat, num, mask):
    qp, mon, temp = state
    return (
        qp["embed"], qp["w1_q"], qp["w1_s"], qp["b1"], qp["w2_q"],
        qp["w2_s"], qp["b2"], mon.num_ref_sorted, mon.num_ref_cdf,
        mon.out_mean, mon.out_precision, mon.out_threshold, temp,
        cat, num, mask,
    )


def _geometries():
    from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS

    shapes = [(1, b) for b in (1, 8, 64, 256)]
    shapes += [(s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS]
    return shapes


def _inputs(prep, s: int, b: int, seed: int, device):
    """Encoded synthetic rows as [S, B, ...] tensors with a partial mask:
    solo buckets drop a quarter of their rows; groups fill slots with
    1..B rows and leave the last slot(s) all padding."""
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    ds = prep.encode(records_to_columns(_records(s * b, seed, drift=0.3)))
    cat = ds.cat_ids.reshape(s, b, -1)
    num = ds.numeric.reshape(s, b, -1)
    rng = np.random.default_rng(seed)
    mask = np.zeros((s, b), bool)
    if s == 1:
        mask[0, : max(1, b - b // 4)] = True
    else:
        for i in range(max(1, s - max(1, s // 4))):
            mask[i, : rng.integers(1, b + 1)] = True
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (cat, num, mask)
    )


def _near_threshold(mon, num, mask):
    from mlops_tpu_torch.ops.outlier import mahalanobis_sq

    d2 = mahalanobis_sq(num.float(), mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    return ((d2 - thr).abs() <= FLAG_BAND * thr.abs()) & mask


def phase_parity(bundle_dir: Path) -> dict:
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
    )

    bundle = load_bundle(bundle_dir)
    dev = torch.device("cuda")
    state = (
        {k: v.to(dev) for k, v in bundle.quant_params.items()},
        bundle.monitor.to(dev),
        torch.tensor(bundle.quant_temperature, dtype=torch.float32, device=dev),
    )
    worst = 0.0
    for k, (s, b) in enumerate(_geometries()):
        cat, num, mask = _inputs(bundle.preprocessor, s, b, 100 + k, dev)
        args = _core_args(state, cat, num, mask)
        kp, kf, kc, kk = fused_core_cuda(*args)
        torch.cuda.synchronize()
        rp, rf, rc, rk = fused_core_reference(*args)
        err = (kp - rp).abs().max().item()
        worst = max(worst, err)
        near = _near_threshold(state[1], num, mask)
        flag_diff = ((kf != rf) & ~near).sum().item()
        ok = (
            torch.equal(kc, rc) and torch.equal(kk, rk)
            and err <= PRED_ATOL and flag_diff == 0
        )
        log(
            f"parity S={s:2d} B={b:3d}: counts/ks exact={torch.equal(kc, rc)}"
            f"/{torch.equal(kk, rk)} preds max|err|={err:.3g} "
            f"flag mismatches={flag_diff} (near threshold {int(near.sum())})"
        )
        check(ok, f"kernel disagrees with its plain version at S={s} B={b}")
    return {"max_abs_err": worst, "shapes": len(_geometries())}


# ------------------------------------------------------------------ phase 5
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(port: int, method: str, path: str, body: bytes | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name):
            return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"/metrics has no {name}")


def _compare_response(got: dict, want: dict, mon, prep, records, what: str,
                      quiet: bool = False):
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    p_err = float(np.abs(
        np.asarray(got["predictions"]) - np.asarray(want["predictions"])
    ).max())
    d_err = float(np.abs(
        np.asarray(list(got["feature_drift_batch"].values()))
        - np.asarray(list(want["feature_drift_batch"].values()))
    ).max())
    check(
        list(got["feature_drift_batch"]) == list(want["feature_drift_batch"]),
        f"{what}: drift keys differ",
    )
    ds = prep.encode(records_to_columns(records))
    num = torch.from_numpy(ds.numeric)
    near = _near_threshold(mon, num, torch.ones(len(records), dtype=torch.bool))
    diff = np.asarray(got["outliers"]) != np.asarray(want["outliers"])
    flag_diff = int((diff & ~near.numpy()).sum())
    if not quiet:
        log(f"{what}: preds |err|={p_err:.3g} drift |err|={d_err:.3g} "
            f"flag mismatches={flag_diff}")
    check(p_err <= PRED_ATOL and d_err <= DRIFT_ATOL and flag_diff == 0,
          f"{what}: response disagrees with the plain version on the CPU")


def phase_serve(bundle_dir: Path, device: str = "cuda") -> dict:
    """The main path. ``device="cpu"`` rehearses it without a card (the
    kernel then never launches); the smoke run itself uses the card."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
    from mlops_tpu_torch.schema.validate import records_to_columns
    from mlops_tpu_torch.serve.engine import InferenceEngine

    bundle = load_bundle(bundle_dir)
    cpu = InferenceEngine(bundle, device="cpu")
    mon_cpu = bundle.monitor
    port = _free_port()
    server_log = WORK / "server.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    bodies = {
        "golden": json.loads((ROOT / "tests/golden/sample-request.json").read_text()),
        "5": _records(5, 11),
        "64": _records(64, 12, drift=0.5),
        "256": _records(256, 13),
    }
    with open(server_log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={bundle_dir}", f"serve.port={port}",
             "serve.host=127.0.0.1", f"serve.device={device}"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 600
        while True:
            check(proc.poll() is None,
                  f"server exited early ({proc.returncode}); see {server_log}")
            try:
                status, _ = _http(port, "GET", "/healthz/ready")
                if status == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "server never became ready")
            time.sleep(0.5)
        status, _ = _http(port, "GET", "/healthz/live")
        check(status == 200, f"/healthz/live answered {status}")
        _, text = _http(port, "GET", "/metrics")
        launches_before = _metric(text.decode(), "mlops_tpu_kernel_launches_total")
        sent = 0
        for name, records in bodies.items():
            status, body = _http(port, "POST", "/predict",
                                 json.dumps(records).encode())
            check(status == 200, f"/predict {name} answered {status}: {body[:200]}")
            got = json.loads(body)
            check(len(got["predictions"]) == len(records), f"{name}: row count")
            check(all(math.isfinite(x) for x in got["predictions"]),
                  f"{name}: non-finite predictions")
            want = cpu.predict_records(records)
            _compare_response(got, want, mon_cpu, bundle.preprocessor,
                              records, f"http {name}")
            sent += len(records)
        status, _ = _http(port, "POST", "/predict",
                          json.dumps(_records(257, 14)).encode())
        check(status == 413, f"257 records answered {status}, expected 413")
        status, _ = _http(port, "POST", "/predict", b'[{"sex": 1}]')
        check(status == 422, f"malformed body answered {status}, expected 422")
        _, text = _http(port, "GET", "/metrics")
        text = text.decode()
        rows = _metric(text, "mlops_tpu_rows_scored_total")
        http_launches = int(
            _metric(text, "mlops_tpu_kernel_launches_total") - launches_before
        )
        log(f"http: rows={rows} sent={sent} kernel launches={http_launches}")
        check(rows == sent, f"/metrics rows {rows} != records sent {sent}")
        expected = len(bodies) if device == "cuda" else 0
        check(http_launches == expected,
              f"{http_launches} kernel launches for {len(bodies)} requests")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        check(code == 0, f"server exit code {code} after SIGTERM")
        check("drained; exiting" in server_log.read_text(),
              "server did not log a clean drain")
        log("http: SIGTERM drained cleanly")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    engine = InferenceEngine(bundle, device=device)
    engine.warmup()
    quant_kernel_launches.reset()
    for rows in (1, 8):
        records = _records(64 * rows, 20 + rows, drift=0.3)
        rng = np.random.default_rng(rows)
        sizes = [1] * 64 if rows == 1 else list(rng.integers(1, 9, size=64))
        sizes[0] = rows
        parts, groups, offset = [], [], 0
        ds = bundle.preprocessor.encode(records_to_columns(records))
        for n in sizes:
            parts.append((ds.cat_ids[offset: offset + n],
                          ds.numeric[offset: offset + n]))
            groups.append(records[offset: offset + n])
            offset += n
        got = engine.fetch_group(engine.dispatch_group_arrays(parts))
        want = cpu.fetch_group(cpu.dispatch_group_arrays(parts))
        check(len(got) == len(parts), f"group 64x{rows}: response count")
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_response(g, w, mon_cpu, bundle.preprocessor, groups[i],
                              f"group 64x{rows} slot {i}", quiet=True)
        log(f"group 64x{rows}: {len(got)} responses agree with the CPU")
    group_launches = quant_kernel_launches.value
    snap = engine.monitor_snapshot()
    check(snap["batches"] == 128, f"grouped batches {snap['batches']} != 128")
    return {"launches": http_launches + group_launches, "engine": engine}


# ------------------------------------------------------------------ phase 6
def _event_ms(fn, iters: int) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _raw_launcher(args, outs, s: int, b: int, r: int):
    """The kernel's C entry point called directly on preallocated outputs,
    so back-to-back launches time the device, not the wrapper's checks."""
    import torch

    from mlops_tpu_torch.ops.quant_kernel import load_library

    lib = load_library()
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.quant_fused_launch(*ptrs, s, b, r, 0, stream)
        if err != 0:
            raise SmokeFailure(f"raw launch failed: cudaError {err}")

    return launch


def _bound(args, outs, s: int, b: int, n_valid: list[int], r: int):
    """Least time for one launch: every input read once and every output
    written once at the HBM rate, against the operations the function
    needs on these inputs at the f32 peak. Operations: the MLP and
    Mahalanobis FMAs (2 ops each) for every row, one category-count
    increment per valid row and categorical, and per slot and numeric
    feature the comparisons of a sort-and-merge ECDF over the slot's n
    valid rows (n log2 n to sort the batch column, R + n to merge it with
    the sorted reference). This is the function's work, not the current
    kernel's dense R x B and B x B comparison planes."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if isinstance(t, torch.Tensor))
    c, e, m, h = 9, 4, 14, 32
    din = c * e + m
    per_row = 2 * din * h + 2 * h + 2 * m * m + 2 * m
    ops = s * b * per_row
    for n in n_valid:
        if n:
            ops += c * n + m * (n * math.ceil(math.log2(max(n, 2))) + r + n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(bundle_dir: Path, engine) -> list[dict]:
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
    )

    bundle = load_bundle(bundle_dir)
    dev = torch.device("cuda")
    state = (
        {k: v.to(dev) for k, v in bundle.quant_params.items()},
        bundle.monitor.to(dev),
        torch.tensor(bundle.quant_temperature, dtype=torch.float32, device=dev),
    )
    r = bundle.monitor.num_ref_sorted.shape[1]
    rows = []
    for s, b in ((1, 1), (1, 256), (64, 1), (64, 8)):
        cat, num, mask = _inputs(bundle.preprocessor, s, b, 300 + s + b, dev)
        args = _core_args(state, cat, num, mask)
        outs = fused_core_cuda(*args)
        kernel_ms = _event_ms(_raw_launcher(args, outs, s, b, r), 200)
        wrapper_ms = _event_ms(lambda: fused_core_cuda(*args), 200)
        plain_ms = _event_ms(lambda: fused_core_reference(*args), 20)
        bound_ms, bound_by = _bound(
            args, outs, s, b, mask.sum(dim=1).tolist(), r
        )
        cat_h, num_h = cat.cpu().numpy(), num.cpu().numpy()
        mask_h = mask.cpu().numpy()
        if s == 1:
            n = int(mask_h[0].sum())

            def call():
                engine.fetch_arrays_raw(
                    engine.dispatch_arrays(cat_h[0, :n], num_h[0, :n])
                )
        else:
            parts = [
                (cat_h[i, : mask_h[i].sum()], num_h[i, : mask_h[i].sum()])
                for i in range(s) if mask_h[i].any()
            ]

            def call():
                engine.fetch_group_raw(engine.dispatch_group_arrays(parts))
        for _ in range(10):
            call()
        times = []
        for _ in range(100):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        row = {
            "shape": f"{s}x{b}",
            "ms": kernel_ms,
            "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "dispatch_fetch_ms_p50": float(np.median(times)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        log(f"timing {json.dumps(row)}")
        rows.append(row)
    return rows


def main() -> int:
    if not (ROOT / "mlops_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(mlops_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        phase_card()
        phase_build()
        bundle_dir = phase_bundle()
        parity = phase_parity(bundle_dir)
        served = phase_serve(bundle_dir)
        timing = phase_timing(bundle_dir, served["engine"])
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1
    import torch

    from mlops_tpu_torch.ops.quant_kernel import REPLACES

    check_launches = served["launches"]
    if check_launches < 1:
        print("chip_smoke FAILED: quant_fused never launched on the main path",
              file=sys.stderr)
        return 1
    head = timing[0]  # bucket 1: the golden request's shape
    kernels = {
        "kernels": [{
            "name": "quant_fused",
            "route": "cuda",
            "source": "mlops_tpu_torch/csrc/quant_fused.cu",
            "replaces": REPLACES,
            "launches": check_launches,
            "max_abs_err": parity["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": head["shape"],
            "timings": timing,
        }],
    }
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
