#!/usr/bin/env python3
"""Where a doc-model training step spends its time on the card.

    python3 scripts/profile_doc_train.py [--steps 10] [--batch 64]

Needs a CUDA card (exits non-zero without one). Builds the trainer of
``configs/long_context_job.toml``'s model (``chip_smoke._doc_config``:
doc_records 11 -> 508 tokens, hidden 256, depth 4, 8 heads, bf16; a
seeded init, learning rate 1e-3), takes ``--batch`` documents of
synthetic rows, warms up, and profiles ``--steps`` training steps
(forward, backward, AdamW) under ``torch.profiler``.

Prints the card's name and power limit, then one JSON line: host wall
time per step with and without the profiler, device busy time and its
share of either wall, and device time per step by
kind of kernel: the flash forward, the two flash backward kernels (dq;
dk/dv), matrix products (cuBLAS), the optimizer's fused multi-tensor
kernels, and everything else (LayerNorm, GELU, bias and residual adds,
casts, gathers, the gradient scatter of the qkv views, copies), with the
operators that take the most device time.
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

from chip_smoke import _doc_config, _doc_trainer, _train_documents  # noqa: E402

_GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    if value is None:  # older torch
        value = event.self_cuda_time_total
    return float(value)


def _kind(name: str) -> str:
    low = name.lower()
    for marker, kind in (
        ("flash_bwd_dq", "flash_bwd_dq"),
        ("flash_bwd_dkv", "flash_bwd_dkv"),
        ("flash_fwd", "flash_fwd"),
    ):
        if marker in low:
            return kind
    if any(m in low for m in _GEMM_MARKERS):
        return "matmul"
    if "multi_tensor" in low:
        return "optimizer"
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=64)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip()
    print(card, flush=True)

    config = _doc_config()
    cat, num, lab = _train_documents(config, args.batch * 11, seed=5, device="cuda")
    trainer = _doc_trainer(config, "cuda", flash=True)
    for _ in range(3):
        trainer.step(cat, num, lab)
    torch.cuda.synchronize()
    # The same steps without the profiler, which inflates host time: the
    # busy share against this wall is the one a training run sees.
    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.step(cat, num, lab)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.step(cat, num, lab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side copies of user annotations (the optimizer's
    # "Optimizer.step#AdamW.step" range) span kernels already counted.
    device = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(_self_device_us(e) for e in device)
    by_kind: dict[str, float] = {}
    for e in device:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + _self_device_us(e)
    top = sorted(device, key=_self_device_us, reverse=True)[:12]
    n = args.steps
    print(json.dumps({
        "card": card,
        "window": f"{n} training steps, batch {args.batch}, 508 tokens, bf16",
        "wall_ms_per_step": wall * 1e3 / n,
        "wall_ms_per_step_unprofiled": plain_wall * 1e3 / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_busy_share_of_unprofiled_wall": busy_us / 1e6 / plain_wall,
        "device_ms_per_step_by_kind": {
            k: v / 1e3 / n for k, v in sorted(by_kind.items())
        },
        "device_ops_per_step": sum(e.count for e in device) / n,
        "top_device_ops_ms_per_step": {
            e.key[:70]: round(_self_device_us(e) / 1e3 / n, 4) for e in top
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
