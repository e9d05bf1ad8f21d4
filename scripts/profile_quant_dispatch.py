#!/usr/bin/env python3
"""Where one quant-tier dispatch of the PyTorch port spends its time on
the card.

    python3 scripts/profile_quant_dispatch.py [--iters 50]

Needs a CUDA card (exits non-zero without one). Builds the same
full-width quant bundle as ``chip_smoke.py`` (its ``phase_bundle``: 20,000
synthetic rows, R=2048, seeded E=4/H=32 student), warms an
``InferenceEngine`` on the card and, for bucket 1,
bucket 256 and groups 64x1 and 64x8, runs ``--iters`` dispatch -> fetch
round trips under ``torch.profiler``. Prints one JSON line per shape:
host wall time per dispatch, device busy time per dispatch (sum of the
kernels' self device time), the fused kernel's device time, device
launches per dispatch, and the operators that take the most device time.
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

from chip_smoke import phase_bundle  # noqa: E402
from mlops_tpu_torch.bundle import load_bundle  # noqa: E402
from mlops_tpu_torch.data import generate_synthetic  # noqa: E402
from mlops_tpu_torch.serve.engine import InferenceEngine  # noqa: E402


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    if value is None:  # older torch
        value = event.self_cuda_time_total
    return float(value)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)

    bundle = load_bundle(phase_bundle())
    engine = InferenceEngine(bundle)
    engine.warmup()
    held, _ = generate_synthetic(4096, seed=1, drift=0.3)
    ds = bundle.preprocessor.encode(held)

    for slots, rows in ((1, 1), (1, 256), (64, 1), (64, 8)):
        if slots == 1:
            cat, num = ds.cat_ids[:rows], ds.numeric[:rows]

            def call():
                engine.fetch_arrays_raw(engine.dispatch_arrays(cat, num))
        else:
            parts = [
                (ds.cat_ids[i * rows:(i + 1) * rows],
                 ds.numeric[i * rows:(i + 1) * rows])
                for i in range(slots)
            ]

            def call():
                engine.fetch_group_raw(engine.dispatch_group_arrays(parts))
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                call()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # Device-side events only (kernels and copies): the CPU operators
        # that launched them carry the same time as "self device" time.
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(_self_device_us(e) for e in device)
        kernel = [e for e in device if "quant_fused" in e.key]
        top = sorted(device, key=_self_device_us, reverse=True)[:8]
        n = args.iters
        print(json.dumps({
            "shape": f"{slots}x{rows}",
            "iters": n,
            "wall_ms_per_dispatch": wall * 1e3 / n,
            "device_busy_ms_per_dispatch": busy_us / 1e3 / n,
            "device_busy_share": busy_us / 1e6 / wall,
            "quant_fused_device_us": (
                sum(_self_device_us(e) for e in kernel)
                / max(1, sum(e.count for e in kernel))
            ),
            "device_ops_per_dispatch": sum(e.count for e in device) / n,
            "quant_fused_launches_per_dispatch": (
                sum(e.count for e in kernel) / n
            ),
            "top_device_ops_us_per_dispatch": {
                e.key[:60]: round(_self_device_us(e) / n, 3) for e in top
            },
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
