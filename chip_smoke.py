#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card of compute capability 9.0 and exits non-zero,
printing no result, without one (or when run from a directory that holds
this script and nothing else of the repository). It imports torch and the
port (``mlops_tpu_torch``), never JAX or the JAX package. Three main
paths: quant-tier serving (``POST /predict``), long-context doc scoring
(``predict-file`` on a ``doc`` bundle) and doc-model training (``train
--config configs/long_context_job.toml model.seq_parallel=false``).
Phases, each of which fails the run loudly:

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions,
   compute capability;
2. build every kernel source of ``mlops_tpu_torch/csrc`` (one nvcc per
   source, all started together), printing the build times and ptxas'
   register/spill/shared-memory summary;
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
   from bytes and operations;
7. the flash-attention kernel against its plain version on the card: the
   doc model's full width (256, 508, 8, 32) bf16 as views of one qkv
   projection, doc_records 3 (4, 140, 2, 16), ragged (2, 200, 4, 64) in
   f32 and bf16, cross-length q 45 / kv 70 in f32; f32 out 2e-5 and lse
   1e-5, bf16 out 2e-2 and lse 1e-3; one launch per call;
8. the doc path at full width: a bundle of the ``long_context_job.toml``
   model (bert, doc_records 11, token_dim 256, depth 4, heads 8, bf16)
   with seeded weights, preprocessor and monitor fitted on 20,000
   synthetic rows; ``python -m mlops_tpu_torch predict-file`` on a
   300*11 + 7-row history CSV at ``serve.max_batch=128`` in a
   subprocess, then the same function in this process (equal output,
   flash launches = depth x chunks = 12), checked against the same
   forward with dense attention on the card and against the port on the
   CPU for the first 16 documents (1e-2 on probabilities);
9. flash timing at full width: the kernel's launch on preallocated
   outputs, the wrapper, the plain version, SDPA as the
   library yardstick, the bound (bytes, tensor-core FLOPs, exponentials),
   and end to end: documents/s of doc scoring at ``max_batch=256`` over
   1,024 documents, forward ms per chunk and the kernel's share of it;
10. the two flash backward kernels (dq; dk and dv) against their plain
    version on the card: the training shape (64, 508, 8, 32) bf16 as
    views of one qkv projection, (4, 140, 2, 16) bf16 and f32, ragged
    (2, 200, 4, 64) f32 and bf16, cross-length q 45 / kv 70 f32; f32
    within 5e-5 + 1e-4 x the gradient's largest magnitude, bf16 within
    two bf16 ulps of it; one launch of each per call;
11. training at full width in this process (the job's model, batch 64,
    bf16, one seeded init): one step's gradients through the flash
    kernels against dense attention, parameter by parameter (cosine
    >= 0.98, norm ratio within 5 %); then 30 steps each way on the same
    batches: loss curves within 0.05 of each other (0.02 on average),
    the flash run's loss falls (mean of the last 10 below the first 10),
    and every step launches exactly depth forwards, depth dq and depth
    dk/dv kernels;
12. the training main path: ``python -m mlops_tpu_torch train --config
    configs/long_context_job.toml model.seq_parallel=false`` in a
    subprocess with ``train.steps`` and ``train.eval_every`` cut (logged;
    widths and rows are the job's), its JSON checked (finite metrics,
    metrics.jsonl, a ``doc`` bundle), the port's ``predict-file`` on the
    bundle it wrote; then the same command's function in this process
    with the launch counts set to 0 just before: dq and dk/dv exactly
    steps x depth, forwards steps x depth plus depth per evaluation
    chunk;
13. training timing: step ms (CUDA events, after warm-up) and documents
    trained per second; each backward kernel's ms beside its bound, the
    plain version's ms and SDPA's backward ms (the library yardstick for
    the pair), and the share of a step the three attention kernels take.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
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

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32
# outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz), dense
# bf16 on the tensor cores. Exponentials: 16 per SM per clock on the
# special-function units, at the same 1.98 GHz maximum boost clock as
# the f32 peak.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12
EXP_OPS_PER_S = 16 * 132 * 1.98e9

FLASH_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}
DOC_PRED_ATOL = 1e-2  # bf16 model: flash vs dense attention, card vs CPU
DOC_DEPTH = 4
JOB_TOML = "configs/long_context_job.toml"

# Flash vs dense attention in training (bf16): per parameter, the cosine
# of the two gradients and the ratio of their norms; the loss curves'
# largest and mean gap. The dense reference rounds its scores to bf16,
# the kernels keep them in f32, so the two differ by bf16 noise.
GRAD_COSINE_MIN = 0.98
GRAD_NORM_RTOL = 0.05
CURVE_MAX_GAP = 0.05
CURVE_MEAN_GAP = 0.02
TRAIN_STEPS_CUT = 40  # of the job's 2,000
TRAIN_EVAL_EVERY_CUT = 20  # of the job's 200

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
@functools.cache
def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    every timing line carries it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def log_timing(label: str, row: dict) -> None:
    log(f"{label} {json.dumps({'card': card_line(), **row})}")


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    log(card_line())
    cap = torch.cuda.get_device_capability(0)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {cap}"
    )
    check(cap == (9, 0), f"need compute capability 9.0, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ phase 2
def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from mlops_tpu_torch.ops import attention, quant_kernel
    from mlops_tpu_torch.ops.cuda_build import build_shared_library

    sources = {
        "quant_fused": quant_kernel.KERNEL_SOURCE,
        "flash_attention": attention.KERNEL_SOURCE,
        "flash_attention_bwd": attention.BWD_KERNEL_SOURCE,
    }
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {
            name: pool.submit(build_shared_library, source, name)
            for name, source in sources.items()
        }
        results = {name: f.result() for name, f in futures.items()}
    for name, result in results.items():
        log(
            f"build {name}: {result.path.name} in {result.seconds:.2f} s"
            + (" (reused)" if result.reused else "")
        )
        for line in result.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    quant_kernel.load_library()
    attention.load_library()
    attention.load_bwd_library()


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
        log_timing("timing", row)
        rows.append(row)
    return rows


# ------------------------------------------------------------------ phase 7
def _qkv_views(b: int, s_q: int, s_kv: int, h: int, d: int, dtype, seed: int):
    """q, k and v as the doc model hands them to the kernel: strided views
    of one [B, S, 3, H, D] projection (separate tensors when q and kv
    differ in length)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            "cuda", dtype
        )

    if s_q == s_kv:
        qkv = normal(b, s_q, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return normal(b, s_q, h, d), normal(b, s_kv, h, d), normal(b, s_kv, h, d)


def phase_flash_parity() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    cases = [
        ("full width", (256, 508, 508, 8, 32), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.bfloat16),
        ("cross-length", (2, 45, 70, 2, 32), torch.float32),
    ]
    rows = []
    for k, (what, shape, dtype) in enumerate(cases):
        q, k_, v = _qkv_views(*shape, dtype, seed=40 + k)
        before = attention.flash_kernel_launches.value
        out, lse = attention.flash_forward_cuda(q, k_, v)
        torch.cuda.synchronize()
        launched = attention.flash_kernel_launches.value - before
        ref_out, ref_lse = attention.flash_forward_reference(q, k_, v)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        name = str(dtype).split(".")[-1]
        out_tol, lse_tol = FLASH_TOL[name]
        row = {
            "case": what, "shape": list(shape), "dtype": name,
            "out_err": out_err, "lse_err": lse_err,
        }
        log(f"flash parity {json.dumps(row)}")
        check(launched == 1, f"flash {what}: launch counter rose by {launched}")
        check(
            math.isfinite(out_err) and out_err <= out_tol and lse_err <= lse_tol,
            f"flash kernel disagrees with its plain version: {row}",
        )
        rows.append(row)
        del q, k_, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return {"max_abs_err": rows[0]["out_err"], "cases": rows}


# ------------------------------------------------------------------ phase 8
def _doc_config():
    from mlops_tpu_torch.config import ModelConfig

    # configs/long_context_job.toml's model, on one card (dense attention).
    return ModelConfig(
        family="bert", doc_records=11, token_dim=256, depth=DOC_DEPTH,
        heads=8, precision="bf16", dropout=0.0,
    )


def phase_doc_bundle(seed: int = 0) -> tuple[Path, Path]:
    from mlops_tpu_torch.bundle import save_doc_bundle
    from mlops_tpu_torch.data import (
        Preprocessor,
        generate_synthetic,
        write_csv_columns,
    )
    from mlops_tpu_torch.models.bert import init_doc_params
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.train.long_context import build_doc_model

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    config = _doc_config()
    model = init_doc_params(build_doc_model(config), seed)
    directory = WORK / "doc_bundle"
    shutil.rmtree(directory, ignore_errors=True)
    save_doc_bundle(
        directory, config, model, prep, fit_monitor(prep.encode(columns)),
        tags={"source": "chip_smoke.py", "note": "seeded weights, not trained"},
    )
    history = WORK / "history.csv"
    rows, _ = generate_synthetic(300 * 11 + 7, seed=seed + 1)
    write_csv_columns(history, rows)
    log(f"doc bundle: {directory}; history: {history} ({300 * 11 + 7} rows)")
    return directory, history


def phase_doc_path(bundle_dir: Path, history: Path, device: str = "cuda") -> dict:
    """The doc path's main run: predict-file in a subprocess and the same
    function here, then the checks against dense attention and the CPU.
    ``device="cpu"`` rehearses it without a card (the kernel then never
    launches); the smoke run itself uses the card."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.commands import predict_documents, predict_file
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.data import load_csv_columns
    from mlops_tpu_torch.models.layers import MultiHeadSelfAttention
    from mlops_tpu_torch.ops.attention import flash_kernel_launches

    overrides = [
        f"data.train_path={history}", f"serve.model_directory={bundle_dir}",
        "serve.max_batch=128", f"serve.device={device}",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "predict-file", *overrides],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0,
          f"predict-file exited {proc.returncode}: {proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    preds = np.asarray(sub["predictions"])
    log(
        f"predict-file subprocess: {time.perf_counter() - t0:.1f} s, "
        f"documents={sub['documents']} records_per_document="
        f"{sub['records_per_document']} rows_dropped={sub['rows_dropped']}"
    )
    check(
        (sub["documents"], sub["records_per_document"], sub["rows_dropped"])
        == (300, 11, 7),
        f"predict-file counts {sub['documents']}/{sub['records_per_document']}"
        f"/{sub['rows_dropped']}, expected 300/11/7",
    )
    check(
        preds.shape == (300,) and np.isfinite(preds).all()
        and (preds >= 0).all() and (preds <= 1).all(),
        "predict-file predictions are not 300 finite probabilities",
    )

    flash_kernel_launches.reset()
    here = predict_file(load_config(overrides))
    launches = flash_kernel_launches.value
    gap = float(np.abs(np.asarray(here["predictions"]) - preds).max())
    log(f"predict-file in process: flash launches={launches}, "
        f"max |gap| to the subprocess={gap:.3g}")
    check(here == sub, "in-process predict-file differs from the subprocess's")
    expected = DOC_DEPTH * math.ceil(300 / 128) if device == "cuda" else 0
    check(launches == expected,
          f"flash launched {launches} times, expected {expected}")

    dense = load_bundle(bundle_dir)
    for mod in dense.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            mod.use_flash = False  # the dense reference at S = 508
    ds = dense.preprocessor.encode(load_csv_columns(history)[0])
    flash_kernel_launches.reset()
    plain = predict_documents(dense, ds, 128, device)
    check(flash_kernel_launches.value == 0, "dense run launched the kernel")
    dense_gap = float(np.abs(np.asarray(plain["predictions"]) - preds).max())

    cpu = load_bundle(bundle_dir)
    n = 16 * 11
    head = type(ds)(cat_ids=ds.cat_ids[:n], numeric=ds.numeric[:n])
    on_cpu = predict_documents(cpu, head, 128, "cpu")
    cpu_gap = float(np.abs(np.asarray(on_cpu["predictions"]) - preds[:16]).max())
    log(f"doc predictions vs dense attention on the card: max |gap| "
        f"{dense_gap:.3g}; vs the port on the CPU (16 documents): {cpu_gap:.3g}")
    check(dense_gap <= DOC_PRED_ATOL and cpu_gap <= DOC_PRED_ATOL,
          f"doc predictions disagree: dense {dense_gap}, cpu {cpu_gap}")
    return {"launches": launches, "dense_gap": dense_gap, "cpu_gap": cpu_gap}


# ------------------------------------------------------------------ phase 9
def _flash_bound(q, out, lse, s_kv: int):
    """Least time for one forward: q, k, v read once and out, lse written
    once at the HBM rate; 4*B*H*Sq*Skv*D FLOPs of products at the bf16
    tensor-core peak; B*H*Sq*Skv exponentials at the special-function
    rate. The largest decides (bytes, or operations)."""
    b, s_q, h, d = q.shape
    nbytes = (b * s_q * h * d + 2 * b * s_kv * h * d) * q.element_size()
    nbytes += out.numel() * out.element_size() + lse.numel() * lse.element_size()
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "tensor_flops": 4 * b * h * s_q * s_kv * d / BF16_TC_FLOPS * 1e3,
        "exponentials": b * h * s_q * s_kv / EXP_OPS_PER_S * 1e3,
    }
    bound = max(terms.values())
    return bound, ("bytes" if terms["bytes"] == bound else "operations"), terms


def phase_flash_timing(bundle_dir: Path) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.commands import predict_documents
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.ops import attention

    q, k, v = _qkv_views(256, 508, 508, 8, 32, torch.bfloat16, seed=90)
    out, lse = attention.flash_forward_cuda(q, k, v)
    # The kernel alone: the wrapper's own launch on preallocated outputs.
    kernel_ms = _event_ms(lambda: attention.launch(q, k, v, out, lse), 50)
    wrapper_ms = _event_ms(lambda: attention.flash_forward_cuda(q, k, v), 50)
    plain_ms = _event_ms(lambda: attention.flash_forward_reference(q, k, v), 5)
    # SDPA's layout, [B,H,S,D], copied outside the timed calls.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = _event_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt), 50
    )
    bound_ms, bound_by, terms = _flash_bound(q, out, lse, k.shape[1])
    del q, k, v, out, lse, qt, kt, vt
    torch.cuda.empty_cache()

    bundle = load_bundle(bundle_dir)
    columns, _ = generate_synthetic(1024 * 11, seed=7)
    ds = bundle.preprocessor.encode(columns)
    predict_documents(bundle, ds, 256, "cuda")  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict_documents(bundle, ds, 256, "cuda")
        walls.append(time.perf_counter() - t0)
    docs_per_s = 1024 / float(np.median(walls))
    cat = torch.from_numpy(ds.cat_ids[: 256 * 11].reshape(256, 11, -1)).cuda()
    num = torch.from_numpy(ds.numeric[: 256 * 11].reshape(256, 11, -1)).cuda()
    with torch.inference_mode():
        chunk_ms = _event_ms(lambda: bundle.model(cat, num), 10)
    row = {
        "shape": "256x508x8x32 bf16",
        "ms": kernel_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_terms_ms": terms,
        "docs_per_s": docs_per_s,
        "chunk_forward_ms": chunk_ms,
        "kernel_share_of_chunk": DOC_DEPTH * kernel_ms / chunk_ms,
    }
    log_timing("flash timing", row)
    return row

# ----------------------------------------------------------------- phase 10
def _grad_tol(want) -> float:
    """f32: 5e-5 + 1e-4 x the largest magnitude (the JAX package's ragged
    flash-gradient tolerance); bf16: two bf16 ulps at it."""
    import torch

    big = want.float().abs().max().item()
    if want.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.floor(math.log2(max(big, 1e-30))) - 7)
    return 5e-5 + 1e-4 * big


def _normal_like(x, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(
        x.device, x.dtype
    )


def phase_bwd_parity() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    cases = [
        ("training shape", (64, 508, 508, 8, 32), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.bfloat16),
        ("cross-length", (2, 45, 70, 2, 32), torch.float32),
    ]
    rows = []
    for n, (what, shape, dtype) in enumerate(cases):
        q, k, v = _qkv_views(*shape, dtype, seed=60 + n)
        do = _normal_like(q, seed=80 + n)
        out, lse = attention.flash_forward_cuda(q, k, v)
        before = (attention.flash_bwd_dq_launches.value,
                  attention.flash_bwd_dkv_launches.value)
        got = attention.flash_backward_cuda(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        launched = (attention.flash_bwd_dq_launches.value - before[0],
                    attention.flash_bwd_dkv_launches.value - before[1])
        want = attention.flash_backward_reference(q, k, v, out, lse, do)
        errs = {
            name: (g.float() - w.float()).abs().max().item()
            for name, g, w in zip(("dq", "dk", "dv"), got, want)
        }
        tols = {name: _grad_tol(w) for name, w in zip(("dq", "dk", "dv"), want)}
        row = {"case": what, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "err": errs, "tol": tols}
        log(f"flash backward parity {json.dumps(row)}")
        check(launched == (1, 1), f"backward {what}: launch counters rose by {launched}")
        check(
            all(math.isfinite(e) and e <= tols[name] for name, e in errs.items()),
            f"flash backward kernels disagree with their plain version: {row}",
        )
        rows.append(row)
        del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return {"dq_err": rows[0]["err"]["dq"],
            "dkv_err": max(rows[0]["err"]["dk"], rows[0]["err"]["dv"]),
            "cases": rows}


# ----------------------------------------------------------------- phase 11
def _launch_counts() -> tuple[int, int, int]:
    from mlops_tpu_torch.ops import attention

    return (attention.flash_kernel_launches.value,
            attention.flash_bwd_dq_launches.value,
            attention.flash_bwd_dkv_launches.value)


def _reset_launch_counts() -> None:
    from mlops_tpu_torch.ops import attention

    for counter in (attention.flash_kernel_launches, attention.flash_bwd_dq_launches,
                    attention.flash_bwd_dkv_launches):
        counter.reset()


def _train_documents(config, rows: int, seed: int, device):
    """Documents of ``rows`` synthetic rows as (cat, num, label) tensors on
    ``device``."""
    import torch

    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.train.long_context import make_documents

    columns, labels = generate_synthetic(rows, seed=seed)
    ds = Preprocessor.fit(columns).encode(columns, labels)
    return tuple(
        torch.from_numpy(a).to(device) for a in make_documents(ds, config.doc_records)
    )


def _doc_trainer(config, device, flash: bool):
    """The job's trainer (learning rate 1e-3, seeded init 0); ``flash``
    False puts every attention module on the dense reference."""
    from mlops_tpu_torch.config import TrainConfig
    from mlops_tpu_torch.models.layers import MultiHeadSelfAttention
    from mlops_tpu_torch.train.long_context import make_doc_train_step

    trainer = make_doc_train_step(
        config, TrainConfig(learning_rate=1e-3, device=str(device)), seed=0
    )
    for mod in trainer.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            mod.use_flash = None if flash else False
    return trainer


def phase_train_parity(config=None, batch: int = 64, steps: int = 30,
                       device: str = "cuda") -> dict:
    """Flash against dense attention in training at the job's width.
    ``device="cpu"`` (with a small ``config``) rehearses it without a
    card: both routes are then dense and nothing launches."""
    import torch

    from mlops_tpu_torch.train.loop import sigmoid_bce
    from mlops_tpu_torch.train.pipeline import _batch_indices

    config = config or _doc_config()
    cat, num, lab = _train_documents(config, 20000, seed=3, device=device)
    n_docs = cat.shape[0]
    on_card = device == "cuda"
    per_step = (config.depth,) * 3 if on_card else (0, 0, 0)

    def batch_of(step):
        idx = torch.from_numpy(_batch_indices(n_docs, batch, 0, step)).to(device)
        return cat[idx], num[idx], lab[idx]

    grads = {}
    for route in ("flash", "dense"):
        trainer = _doc_trainer(config, device, route == "flash")
        _reset_launch_counts()
        c, x, y = batch_of(1)
        sigmoid_bce(trainer.model(c, x), y).backward()
        counts = _launch_counts()
        want = per_step if route == "flash" else (0, 0, 0)
        check(counts == want, f"{route} gradient step launched {counts}, expected {want}")
        grads[route] = {k: p.grad.float().flatten() for k, p in trainer.model.named_parameters()}
        del trainer
    stats = []
    for name, g in grads["flash"].items():
        d = grads["dense"][name]
        cos = torch.nn.functional.cosine_similarity(g, d, dim=0).item()
        ratio = (g.norm() / d.norm().clamp_min(1e-30)).item()
        stats.append((name, cos, ratio))
        check(cos >= GRAD_COSINE_MIN and abs(ratio - 1) <= GRAD_NORM_RTOL,
              f"{name}: flash vs dense gradient cosine {cos:.5f}, norm ratio {ratio:.5f}")
    cos_name, worst_cos, _ = min(stats, key=lambda t: t[1])
    ratio_name, _, worst_ratio = max(stats, key=lambda t: abs(t[2] - 1))
    log(f"train gradients flash vs dense ({len(stats)} parameters): worst "
        f"cosine {worst_cos:.6f} ({cos_name}), worst norm ratio "
        f"{worst_ratio:.6f} ({ratio_name})")
    del grads

    curves = {}
    for route in ("flash", "dense"):
        trainer = _doc_trainer(config, device, route == "flash")
        losses = []
        for step in range(1, steps + 1):
            _reset_launch_counts()
            losses.append(float(trainer.step(*batch_of(step))))
            counts = _launch_counts()
            want = per_step if route == "flash" else (0, 0, 0)
            check(counts == want, f"{route} step {step} launched {counts}, expected {want}")
        curves[route] = losses
        del trainer
    gaps = [abs(a - b) for a, b in zip(curves["flash"], curves["dense"])]
    first, last = sum(curves["flash"][:10]) / 10, sum(curves["flash"][-10:]) / 10
    row = {
        "steps": steps, "batch": batch, "max_gap": max(gaps),
        "mean_gap": sum(gaps) / len(gaps), "first10_mean": first, "last10_mean": last,
        "flash": [round(v, 5) for v in curves["flash"]],
        "dense": [round(v, 5) for v in curves["dense"]],
    }
    log(f"train loss curves {json.dumps(row)}")
    check(all(math.isfinite(v) for v in curves["flash"] + curves["dense"]),
          "non-finite training loss")
    check(max(gaps) <= CURVE_MAX_GAP and row["mean_gap"] <= CURVE_MEAN_GAP,
          f"flash and dense loss curves part: max {max(gaps)}, mean {row['mean_gap']}")
    check(last < first, f"the flash run's loss does not fall: {first} -> {last}")
    if on_card:
        torch.cuda.empty_cache()
    return {"worst_cosine": worst_cos, "worst_norm_ratio": worst_ratio, **row}


# ----------------------------------------------------------------- phase 12
def phase_train_path(history: Path, extra: tuple[str, ...] = (),
                     device: str = "cuda") -> dict:
    """The training main path: the CLI in a subprocess, predict-file on
    its bundle, then the same function here with the launch counts read.
    ``extra`` overrides and ``device="cpu"`` rehearse it small on the CPU
    (nothing launches there)."""
    import numpy as np

    from mlops_tpu_torch.commands import predict_file, train
    from mlops_tpu_torch.config import load_config

    root = WORK / "train"
    shutil.rmtree(root, ignore_errors=True)
    cuts = [f"train.steps={TRAIN_STEPS_CUT}", f"train.eval_every={TRAIN_EVAL_EVERY_CUT}"]
    overrides = [
        "model.seq_parallel=false", *cuts, f"registry.root={root / 'registry'}",
        f"registry.run_root={root / 'runs'}", f"train.device={device}", *extra,
    ]
    config = load_config(overrides, ROOT / JOB_TOML)
    log(f"train: {JOB_TOML} with model.seq_parallel=false (one card: the dense "
        f"path); cut: {' '.join(cuts)} (the job: train.steps=2000 "
        f"train.eval_every=200); rows {config.data.rows}, batch "
        f"{config.train.batch_size}, {config.model.token_dim}/{config.model.depth}/"
        f"{config.model.heads}, {config.model.precision}: the job's")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "train", "--config", JOB_TOML,
         *overrides, "registry.run_name=cli"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=900,
    )
    check(proc.returncode == 0, f"train exited {proc.returncode}: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"train subprocess: {time.perf_counter() - t0:.1f} s: {json.dumps(out)}")
    check(set(out) == {"bundle", "model_uri", "run_dir", "steps", "packaged_step", "metrics"},
          f"train printed keys {sorted(out)}")
    check(out["steps"] == TRAIN_STEPS_CUT and out["packaged_step"] == TRAIN_STEPS_CUT,
          f"train steps {out['steps']}/{out['packaged_step']}")
    check(len(out["metrics"]) == 5 and all(math.isfinite(v) for v in out["metrics"].values()),
          f"train metrics {out['metrics']}")
    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    check([r["step"] for r in rows] == list(
        range(TRAIN_EVAL_EVERY_CUT, TRAIN_STEPS_CUT + 1, TRAIN_EVAL_EVERY_CUT)),
        f"metrics.jsonl steps {[r['step'] for r in rows]}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    check(manifest["flavor"] == "doc" and manifest["tags"]["trained_with"]
          == "long_context dense", "the bundle is not a dense-trained doc bundle")

    scored = predict_file(load_config([
        f"data.train_path={history}", f"serve.model_directory={out['bundle']}",
        "serve.max_batch=128", f"serve.device={device}",
    ]))
    preds = np.asarray(scored["predictions"])
    log(f"predict-file on the trained bundle: {scored['documents']} documents, "
        f"mean probability {preds.mean():.4f}")
    check(scored["documents"] == 300 and np.isfinite(preds).all()
          and ((preds >= 0) & (preds <= 1)).all(),
          "predict-file on the trained bundle: not 300 finite probabilities")

    config.registry.run_name = "in_process"
    _reset_launch_counts()
    here = train(config)
    counts = _launch_counts()
    valid_docs = int(config.data.rows * config.data.valid_fraction) // config.model.doc_records
    chunks = math.ceil(valid_docs / 256)
    evals = TRAIN_STEPS_CUT // TRAIN_EVAL_EVERY_CUT + 1  # and the calibration's
    depth = config.model.depth
    want = (
        (depth * (TRAIN_STEPS_CUT + evals * chunks), depth * TRAIN_STEPS_CUT,
         depth * TRAIN_STEPS_CUT) if device == "cuda" else (0, 0, 0)
    )
    log(f"train in process: launches forward/dq/dkv {counts} (expected {want}); "
        f"metrics {json.dumps(here['metrics'])}")
    check(counts == want, f"training launched {counts}, expected {want}")
    return {"launches": counts, "cli": out, "in_process": here}


# ----------------------------------------------------------------- phase 13
def _bwd_bound(q, k, outputs: int):
    """Least time for one backward kernel: q, k, v, do read once, lse and
    delta once, ``outputs`` gradient tensors written once, at the HBM
    rate; its products (3 for dq, 4 for dk/dv, each 2*B*H*Sq*Skv*D FLOPs)
    at the bf16 tensor-core peak; B*H*Sq*Skv exponentials at the
    special-function rate. The largest decides."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    el = q.element_size()
    nbytes = (2 * b * s_q * h * d + 2 * b * s_kv * h * d) * el + 2 * b * h * s_q * 4
    nbytes += outputs * (b * (s_q if outputs == 1 else s_kv) * h * d) * el
    products = 3 if outputs == 1 else 4
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "tensor_flops": products * 2 * b * h * s_q * s_kv * d / BF16_TC_FLOPS * 1e3,
        "exponentials": b * h * s_q * s_kv / EXP_OPS_PER_S * 1e3,
    }
    bound = max(terms.values())
    return bound, ("bytes" if terms["bytes"] == bound else "operations"), terms


def phase_train_timing() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    config = _doc_config()
    cat, num, lab = _train_documents(config, 64 * 11, seed=5, device="cuda")
    trainer = _doc_trainer(config, "cuda", flash=True)
    step_ms = _event_ms(lambda: trainer.step(cat, num, lab), 20)
    del trainer
    torch.cuda.empty_cache()

    q, k, v = _qkv_views(64, 508, 508, 8, 32, torch.bfloat16, seed=92)
    do = _normal_like(q, seed=93)
    out, lse = attention.flash_forward_cuda(q, k, v)
    delta = attention.flash_delta(out, do)
    dq = torch.empty_like(out)
    dk, dv = torch.empty_like(out), torch.empty_like(out)
    dq_ms = _event_ms(lambda: attention.launch_dq(q, k, v, do, lse, delta, dq), 50)
    dkv_ms = _event_ms(lambda: attention.launch_dkv(q, k, v, do, lse, delta, dk, dv), 50)
    plain_ms = _event_ms(
        lambda: attention.flash_backward_reference(q, k, v, out, lse, do), 5
    )
    # SDPA's backward (its flash backend) as one call of the aten op, in
    # its layout [B,H,S,D] copied outside the timed calls, as the kernels
    # are timed through their launch helpers: no autograd on the host,
    # whose speed would otherwise decide the time.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    fo = sdpa_fwd(qt, kt, vt, 0.0, False, False)
    bwd_args = (dot, qt, kt, vt, *fo[:6], 0.0, False, fo[6], fo[7])
    library_ms = _event_ms(lambda: sdpa_bwd(*bwd_args), 50)
    sdpa_fwd_ms = _event_ms(lambda: sdpa_fwd(qt, kt, vt, 0.0, False, False), 50)
    sdpa_dq = sdpa_bwd(*bwd_args)[0].transpose(1, 2)
    ours_dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    sdpa_gap = (sdpa_dq.float() - ours_dq.float()).abs().max().item()
    dq_bound, dq_by, dq_terms = _bwd_bound(q, k, 1)
    dkv_bound, dkv_by, dkv_terms = _bwd_bound(q, k, 2)
    depth = config.depth
    row = {
        "shape": "64x508x8x32 bf16",
        "step_ms": step_ms,
        "docs_per_s": 64 / step_ms * 1e3,
        "dq_ms": dq_ms, "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
        "dq_bound_terms_ms": dq_terms,
        "dkv_ms": dkv_ms, "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
        "dkv_bound_terms_ms": dkv_terms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "sdpa_fwd_ms": sdpa_fwd_ms,
        "dq_max_gap_to_sdpa": sdpa_gap,
        "fwd_ms_at_batch_64": _event_ms(lambda: attention.launch(q, k, v, out, lse), 50),
    }
    row["attention_share_of_step"] = (
        depth * (row["fwd_ms_at_batch_64"] + dq_ms + dkv_ms) / step_ms
    )
    log_timing("train timing", row)
    del q, k, v, do, out, lse, delta, dq, dk, dv, qt, kt, vt, dot, fo, sdpa_dq, ours_dq
    torch.cuda.empty_cache()
    return row


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
        flash = phase_flash_parity()
        doc_dir, history = phase_doc_bundle()
        doc = phase_doc_path(doc_dir, history)
        flash_timing = phase_flash_timing(doc_dir)
        bwd = phase_bwd_parity()
        train_parity = phase_train_parity()
        trained = phase_train_path(history)
        train_timing = phase_train_timing()
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1
    import torch

    from mlops_tpu_torch.ops import attention
    from mlops_tpu_torch.ops.quant_kernel import REPLACES

    check_launches = served["launches"]
    if check_launches < 1:
        print("chip_smoke FAILED: quant_fused never launched on the main path",
              file=sys.stderr)
        return 1
    head = timing[0]  # bucket 1: the golden request's shape
    train_fwd, train_dq, train_dkv = trained["launches"]
    bwd_common = {
        "route": "cuda",
        "source": "mlops_tpu_torch/csrc/flash_attention_bwd.cu",
        "plain_ms": train_timing["plain_ms"],  # the plain version computes the pair
        "library_ms": train_timing["library_ms"],  # SDPA's backward: the pair
        "shape": train_timing["shape"],
        "parity": bwd["cases"],
    }
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
        }, {
            "name": "flash_attention",
            "route": "cuda",
            "source": "mlops_tpu_torch/csrc/flash_attention.cu",
            "replaces": attention.REPLACES,
            "launches": doc["launches"],
            "train_launches": train_fwd,
            "max_abs_err": flash["max_abs_err"],
            "ms": flash_timing["ms"],
            "plain_ms": flash_timing["plain_ms"],
            "bound_ms": flash_timing["bound_ms"],
            "bound_by": flash_timing["bound_by"],
            "library_ms": flash_timing["library_ms"],
            "shape": flash_timing["shape"],
            "timing": flash_timing,
            "parity": flash["cases"],
            "doc_path": doc,
        }, {
            "name": "flash_bwd_dq",
            "replaces": attention.BWD_DQ_REPLACES,
            "launches": train_dq,
            "max_abs_err": bwd["dq_err"],
            "ms": train_timing["dq_ms"],
            "bound_ms": train_timing["dq_bound_ms"],
            "bound_by": train_timing["dq_bound_by"],
            **bwd_common,
        }, {
            "name": "flash_bwd_dkv",
            "replaces": attention.BWD_DKV_REPLACES,
            "launches": train_dkv,
            "max_abs_err": bwd["dkv_err"],
            "ms": train_timing["dkv_ms"],
            "bound_ms": train_timing["dkv_bound_ms"],
            "bound_by": train_timing["dkv_bound_by"],
            **bwd_common,
        }],
        "train": {
            "parity": train_parity,
            "timing": train_timing,
            "metrics": trained["cli"]["metrics"],
        },
    }
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line(), flush=True)
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
