#!/usr/bin/env python3
"""Where the doc model's ``predict-file`` forward spends its time on the
card.

    python3 scripts/profile_doc_forward.py [--iters 10]

Needs a CUDA card (exits non-zero without one). Builds the same
full-width doc bundle as ``chip_smoke.py`` (its ``phase_doc_bundle``: the
``long_context_job.toml`` model, doc_records 11 -> 508 tokens, hidden
256, depth 4, 8 heads, bf16, seeded weights), loads it on the card and
profiles under ``torch.profiler``:

1. ``--iters`` forwards of one 256-document chunk (the shape
   ``predict-file serve.max_batch=256`` runs);
2. one ``predict_documents`` call over 1,024 documents (4 chunks, with
   its host-side grouping, padding, copies and sigmoid).

Prints the card's name and power limit, then one JSON line per window:
host wall time, device busy time and share, and device time by kind of
kernel: the flash-attention kernel, matrix products (cuBLAS), and
everything else (LayerNorm, GELU, bias and residual adds, casts,
gathers, copies), with the operators that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import WORK, phase_doc_bundle  # noqa: E402
from mlops_tpu_torch.bundle import load_bundle  # noqa: E402
from mlops_tpu_torch.commands import predict_documents  # noqa: E402
from mlops_tpu_torch.data import generate_synthetic  # noqa: E402

_GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    if value is None:  # older torch
        value = event.self_cuda_time_total
    return float(value)


def _kind(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_kernel"
    if any(m in low for m in _GEMM_MARKERS):
        return "matmul"
    return "other"


def _window(label: str, fn, iters: int) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(_self_device_us(e) for e in device)
    by_kind: dict[str, float] = {}
    for e in device:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + _self_device_us(e)
    top = sorted(device, key=_self_device_us, reverse=True)[:10]
    print(json.dumps({
        "window": label,
        "iters": iters,
        "wall_ms_per_iter": wall * 1e3 / iters,
        "device_busy_ms_per_iter": busy_us / 1e3 / iters,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_ms_per_iter_by_kind": {
            k: v / 1e3 / iters for k, v in sorted(by_kind.items())
        },
        "device_ops_per_iter": sum(e.count for e in device) / iters,
        "top_device_ops_ms_per_iter": {
            e.key[:70]: round(_self_device_us(e) / 1e3 / iters, 4) for e in top
        },
    }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)

    WORK.mkdir(parents=True, exist_ok=True)
    bundle_dir, _ = phase_doc_bundle()
    bundle = load_bundle(bundle_dir)
    model = bundle.model.to("cuda")
    columns, _ = generate_synthetic(1024 * 11, seed=7)
    ds = bundle.preprocessor.encode(columns)
    cat = torch.from_numpy(ds.cat_ids[: 256 * 11].reshape(256, 11, -1)).cuda()
    num = torch.from_numpy(ds.numeric[: 256 * 11].reshape(256, 11, -1)).cuda()

    with torch.inference_mode():
        for _ in range(3):
            model(cat, num)
        _window("chunk forward, 256 documents", lambda: model(cat, num), args.iters)
    predict_documents(bundle, ds, 256, "cuda")  # warm-up
    _window(
        "predict_documents, 1024 documents at max_batch=256",
        lambda: predict_documents(bundle, ds, 256, "cuda"), 1,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
