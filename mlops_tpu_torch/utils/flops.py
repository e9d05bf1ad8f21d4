"""FLOP accounting and MFU (model FLOPs utilization) on the H100.

The port's counterpart of the JAX package's ``utils/flops.py``, written
for the card rather than copied: there is no XLA cost model here, so a
program's FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
(its per-aten-op formulas: 2*M*N*K for a matmul), and the peak is a table
of NVIDIA's published H100 rates, one entry per form factor and one rate
per executing precision.

Peaks: NVIDIA H100 Tensor Core GPU datasheet, dense rates (the datasheet
quotes the tensor-core rates with 2:4 sparsity; dense is half of it).

============  ==========  ==========  ===========  ===========  =========
part          bf16/fp16   tf32        f32 (SIMT)   fp8/int8     HBM
============  ==========  ==========  ===========  ===========  =========
H100 SXM      989 TF/s    495 TF/s    67 TF/s      1,979 T/s    3.35 TB/s
H100 PCIe     756 TF/s    378 TF/s    51 TF/s      1,513 T/s    2.0 TB/s
H100 NVL      835 TF/s    417.5 TF/s  60 TF/s      1,670.5 T/s  3.9 TB/s
============  ==========  ==========  ===========  ===========  =========

The ratios are the card's, not a TPU's: f32 outside the tensor cores is
about 1/15 of dense bf16 on the H100, where the JAX table's TPU f32 was
1/2. The rates assume the part's full power limit (700 W for the SXM
part); a card set below it runs slower under load, so a share of peak is
stated with the card's power limit beside it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable

logger = logging.getLogger(__name__)

# The H100 SXM part's peaks: the bounds chip_smoke.py states for its
# kernels.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12

# Dense peaks per H100 form factor (ops/s) and HBM rate (bytes/s).
_PEAKS: dict[str, dict[str, float]] = {
    "sxm": {"bf16": BF16_TC_FLOPS, "tf32": 495e12, "f32": F32_OPS_PER_S,
            "fp8": 1979e12, "hbm": HBM_BYTES_PER_S},
    "pcie": {"bf16": 756e12, "tf32": 378e12, "f32": 51e12,
             "fp8": 1513e12, "hbm": 2.0e12},
    "nvl": {"bf16": 835e12, "tf32": 417.5e12, "f32": 60e12,
            "fp8": 1670.5e12, "hbm": 3.9e12},
}
# Executing precision -> the table's column (int8 runs at the fp8 rate).
_DTYPE_COLUMN: dict[str, str] = {
    "bf16": "bf16", "bfloat16": "bf16", "fp16": "bf16", "float16": "bf16",
    "tf32": "tf32",
    "f32": "f32", "float32": "f32",
    "fp8": "fp8", "int8": "fp8",
}


def device_name(device: Any) -> str:
    """The name ``torch.cuda.get_device_name`` gives ``device`` (a card
    index or a ``cuda`` device); a name string is taken as it is, and a
    CPU device has the empty name."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch

    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def h100_part(name: str) -> str | None:
    """``sxm``, ``pcie`` or ``nvl`` for an H100's device name ("NVIDIA H100
    80GB HBM3" is the SXM part), None for any other or unknown name."""
    lowered = name.lower()
    if "h100" not in lowered:
        return None
    if "pcie" in lowered:
        return "pcie"
    if "nvl" in lowered:
        return "nvl"
    if "hbm3" in lowered or "sxm" in lowered:
        return "sxm"
    return None


def peak_flops(device: Any, dtype: str = "bf16") -> float | None:
    """The published dense peak (ops/s) of ``device`` at executing
    precision ``dtype`` (bf16/fp16, tf32, f32, fp8/int8 and aliases), or
    None for a card the table does not know.

    ``MLOPS_TPU_PEAK_FLOPS`` overrides it verbatim, with no dtype scaling
    (a rate measured at whatever precision it was measured at)."""
    if dtype not in _DTYPE_COLUMN:
        raise ValueError(
            f"unknown executing dtype {dtype!r}; expected one of "
            f"{sorted(_DTYPE_COLUMN)}"
        )
    override = os.environ.get("MLOPS_TPU_PEAK_FLOPS")
    if override:
        return float(override)
    part = h100_part(device_name(device))
    return None if part is None else _PEAKS[part][_DTYPE_COLUMN[dtype]]


def peak_bytes_per_s(device: Any) -> float | None:
    """The published HBM rate of ``device`` (bytes/s), None when unknown."""
    part = h100_part(device_name(device))
    return None if part is None else _PEAKS[part]["hbm"]


def compile_with_flops(fn: Callable, *args) -> tuple[Callable | None, float | None]:
    """Run ``fn(*args)`` once under ``FlopCounterMode``; return ``(fn,
    flops)``. There is no compile step in eager PyTorch: the callable
    comes back as it is, ready to be timed. ``(None, None)`` when the
    call fails; the flops are None when the counter saw no counted op."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    try:
        with counter:
            fn(*args)
    # The contract is "None when this call cannot be counted": any
    # failure of the user's function qualifies, logged so the cause is
    # never silent.
    except Exception as err:  # tpulint: disable=TPU201
        logger.debug("FLOP counting call failed: %s", err)
        return None, None
    flops = float(counter.get_total_flops())
    return fn, (flops if flops > 0 else None)


def compiled_flops(fn: Callable, *args) -> float | None:
    """FLOPs of one call of ``fn(*args)`` (None when unavailable)."""
    return compile_with_flops(fn, *args)[1]


def measured_gemm_peak(n: int = 8192, reps: int = 10, dtype: str = "bf16",
                       device: Any = "cuda") -> float:
    """The card's measured dense GEMM rate (FLOP/s): the best of ``reps``
    ``n x n @ n x n`` products at ``dtype`` (bf16, fp16 or f32), each
    timed between CUDA events on the current stream. On the card only:
    a CPU device raises."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measured_gemm_peak times the card, got {device}")
    torch_dtype = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                   "fp16": torch.float16, "float16": torch.float16,
                   "f32": torch.float32, "float32": torch.float32}[dtype]
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch_dtype)
    b = torch.randn((n, n), generator=gen, device=device).to(torch_dtype)
    out = torch.empty((n, n), device=device, dtype=torch_dtype)
    torch.matmul(a, b, out=out)  # cuBLAS's handle and heuristics
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.matmul(a, b, out=out)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return 2.0 * n**3 / best


def mfu(flops_per_call: float | None, calls_per_s: float, peak: float | None):
    """Fraction of peak, rounded as the JAX package rounds it; None when
    either side is unknown."""
    if not flops_per_call or not peak or calls_per_s <= 0:
        return None
    return round(flops_per_call * calls_per_s / peak, 4)
