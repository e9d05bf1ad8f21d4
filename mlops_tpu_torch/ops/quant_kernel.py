"""Fused packed predict for the quantized student tier.

Port of the JAX package's ``ops/quant_kernel.py``. The whole per-request
body — student forward, Mahalanobis outlier flags, categorical batch
counts and the dense masked K-S statistics — is one hand-written CUDA
kernel (``csrc/quant_fused.cu``), the Hopper counterpart of the Pallas
``_fused_kernel``. Beside it, ``fused_core_reference`` is the same body in
plain PyTorch: the CPU route and the kernel's parity reference.

Routing is by device and nothing else: tensors on the CPU go to the plain
version; tensors on a CUDA card launch the kernel, or the call raises.

Outside the kernel, in plain torch as in the reference: the chi-squared
and Kolmogorov p-values, the ``1 - p`` drift assembly and the accumulator
fold. Slots are a leading dimension everywhere — the solo path is one
slot — so a grouped dispatch is still a single launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Callable

import torch

from mlops_tpu_torch.monitor.state import (
    MonitorAccumulator,
    MonitorState,
    fold_accumulator,
    fold_accumulator_grouped,
)
from mlops_tpu_torch.ops.cuda_build import PACKAGE_DIR, build_shared_library
from mlops_tpu_torch.ops.drift import (
    _kolmogorov_sf,
    chi2_two_sample,
    ks_small_masked_statistic,
)
from mlops_tpu_torch.ops.outlier import mahalanobis_sq
from mlops_tpu_torch.ops.quant import QUANT_EMBED_DIM, QUANT_HIDDEN
from mlops_tpu_torch.ops.quant import (
    dequantize_dense,
    one_hot_2d,
    student_logits,
)
from mlops_tpu_torch.schema.features import SCHEMA

KERNEL_SOURCE = PACKAGE_DIR / "csrc" / "quant_fused.cu"
# Where the Pallas kernel this one replaces lives in the JAX package.
REPLACES = "mlops_tpu/ops/quant_kernel.py:167"

# Shared memory a block may use on an H100 (232,448 bytes), less room for
# the kernel's static arrays.
_SMEM_LIMIT = 232_448 - 2_048

# The geometry csrc/quant_fused.cu is compiled for.
_C = SCHEMA.num_categorical
_K = max(SCHEMA.cards)
_M = SCHEMA.num_numeric
_E = QUANT_EMBED_DIM
_H = QUANT_HIDDEN


class LaunchCounter:
    """How many times a kernel was launched: a plain integer the wrapper
    bumps at each launch (thread-safe; the server scores from a pool)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


quant_kernel_launches = LaunchCounter()

_library: ctypes.CDLL | None = None
_library_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's shared library."""
    global _library
    with _library_lock:
        if _library is None:
            lib = ctypes.CDLL(
                str(build_shared_library(KERNEL_SOURCE, "quant_fused").path)
            )
            ptr = ctypes.c_void_p
            lib.quant_fused_launch.argtypes = [ptr] * 20 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
            ]
            lib.quant_fused_launch.restype = ctypes.c_int
            _library = lib
        return _library


def max_rows(r: int) -> int:
    """Largest rows-per-slot one launch takes for a reference of ``r``
    points: the K-S blocks hold 2r + B floats in shared memory."""
    return (_SMEM_LIMIT - 8 * r) // 4


def fused_core_reference(
    embed: torch.Tensor,  # bf16 [C, K, E]
    w1_q: torch.Tensor,  # int8 [Din, H]
    w1_s: torch.Tensor,  # f32 [H]
    b1: torch.Tensor,  # f32 [H]
    w2_q: torch.Tensor,  # int8 [H]
    w2_s: torch.Tensor,  # f32 []
    b2: torch.Tensor,  # f32 []
    ref_sorted: torch.Tensor,  # f32 [M, R]
    ref_cdf: torch.Tensor,  # f32 [M, R]
    mean: torch.Tensor,  # f32 [M]
    precision: torch.Tensor,  # f32 [M, M]
    threshold: torch.Tensor,  # f32 []
    temperature: torch.Tensor,  # f32 []
    cat_ids: torch.Tensor,  # int32 [S, B, C]
    numeric: torch.Tensor,  # f32 [S, B, M]
    mask: torch.Tensor,  # bool [S, B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused body in plain PyTorch (the JAX package's ``_fused_core``
    over a leading slot dimension). Returns ``(preds [S,B], flags [S,B],
    counts [S,C,K], ks [S,M])``, all f32."""
    k = embed.shape[1]
    numeric = numeric.float()
    maskf = mask.float()
    logits = student_logits(
        embed, dequantize_dense(w1_q, w1_s), b1, w2_q.float() * w2_s, b2,
        cat_ids, numeric,
    )  # [S, B]
    preds = torch.sigmoid(logits / temperature)
    # Masked one-hot counts per (feature, category): [S, C, K].
    cat_counts = (one_hot_2d(cat_ids, k) * maskf[..., None, None]).sum(dim=1)

    flags = (mahalanobis_sq(numeric, mean, precision) > threshold).float()
    flags = flags * maskf

    ks = ks_small_masked_statistic(
        ref_sorted[None], ref_cdf[None], numeric.transpose(1, 2),
        mask[:, None, :],
    )  # [S, M]
    return preds, flags, cat_counts, ks


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_core_cuda(
    embed, w1_q, w1_s, b1, w2_q, w2_s, b2, ref_sorted, ref_cdf, mean,
    precision, threshold, temperature, cat_ids, numeric, mask,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/quant_fused.cu`` on the current stream: same
    arguments and results as ``fused_core_reference``."""
    device = cat_ids.device
    if device.type != "cuda":
        raise ValueError(f"fused_core_cuda takes CUDA tensors, got {device}")
    if cat_ids.dim() != 3:
        raise ValueError(f"cat_ids must be [S, B, C], got {tuple(cat_ids.shape)}")
    s, b = cat_ids.shape[0], cat_ids.shape[1]
    r = ref_sorted.shape[-1]
    if s < 1 or b < 1 or r < 1:
        raise ValueError(f"empty launch: S={s}, B={b}, R={r}")
    if b > max_rows(r):
        raise ValueError(
            f"B={b} rows per slot exceed the kernel's shared-memory layout "
            f"({max_rows(r)} rows at R={r})"
        )
    f32, scalar = torch.float32, ()
    for t, name, dtype, shape in (
        (embed, "embed", torch.bfloat16, (_C, _K, _E)),
        (w1_q, "w1_q", torch.int8, (_C * _E + _M, _H)),
        (w1_s, "w1_s", f32, (_H,)),
        (b1, "b1", f32, (_H,)),
        (w2_q, "w2_q", torch.int8, (_H,)),
        (w2_s, "w2_s", f32, scalar),
        (b2, "b2", f32, scalar),
        (ref_sorted, "ref_sorted", f32, (_M, r)),
        (ref_cdf, "ref_cdf", f32, (_M, r)),
        (mean, "mean", f32, (_M,)),
        (precision, "precision", f32, (_M, _M)),
        (threshold, "threshold", f32, scalar),
        (temperature, "temperature", f32, scalar),
        (cat_ids, "cat_ids", torch.int32, (s, b, _C)),
        (numeric, "numeric", f32, (s, b, _M)),
        (mask, "mask", torch.bool, (s, b)),
    ):
        _check(t, name, dtype, shape, device)
    preds = torch.empty((s, b), dtype=f32, device=device)
    flags = torch.empty((s, b), dtype=f32, device=device)
    counts = torch.empty((s, _C, _K), dtype=f32, device=device)
    ks = torch.empty((s, _M), dtype=f32, device=device)
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.quant_fused_launch(
        *(
            t.data_ptr()
            for t in (
                embed, w1_q, w1_s, b1, w2_q, w2_s, b2, ref_sorted, ref_cdf,
                mean, precision, threshold, temperature, cat_ids, numeric,
                mask, preds, flags, counts, ks,
            )
        ),
        s, b, r, device.index if device.index is not None else 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_fused kernel launch failed: cudaError {err}")
    quant_kernel_launches.add()
    return preds, flags, counts, ks


def fused_core(*args) -> tuple[torch.Tensor, ...]:
    """The fused body routed by device: the plain version for tensors on
    the CPU, the CUDA kernel for tensors on the card."""
    device = args[13].device  # cat_ids
    if device.type == "cpu":
        return fused_core_reference(*args)
    return fused_core_cuda(*args)


def quant_fused(
    qparams: dict[str, torch.Tensor],
    monitor: MonitorState,
    temperature: torch.Tensor,
    cat_ids: torch.Tensor,  # int32 [S, B, C]
    numeric: torch.Tensor,  # f32 [S, B, M]
    mask: torch.Tensor,  # bool [S, B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused quant predict for S padded request slots:
    ``(preds [S,B], flags [S,B], drift [S,D])``, drift computed over each
    slot's own rows."""
    preds, flags, cat_counts, ks_stat = fused_core(
        qparams["embed"], qparams["w1_q"], qparams["w1_s"], qparams["b1"],
        qparams["w2_q"], qparams["w2_s"], qparams["b2"],
        monitor.num_ref_sorted, monitor.num_ref_cdf,
        monitor.out_mean, monitor.out_precision, monitor.out_threshold,
        temperature, cat_ids, numeric, mask,
    )
    # P-values and drift in the order of the reference's drift_scores:
    # categorical then numeric.
    _, cat_p = chi2_two_sample(monitor.cat_ref_counts[None], cat_counts)
    r = monitor.num_ref_sorted.shape[1]
    n_valid = torch.clamp(mask.float().sum(dim=1), min=1.0)[:, None]
    en = torch.sqrt(r * n_valid / (r + n_valid))
    ks_p = _kolmogorov_sf((en + 0.12 + 0.11 / en) * ks_stat)
    drift = 1.0 - torch.cat([cat_p, ks_p], dim=1)
    return preds, flags, drift


def make_quant_packed_base() -> Callable:
    """Solo packed program: ``(qparams, monitor, acc, temperature,
    cat_ids [B,C], numeric [B,M], mask [B]) -> (packed f32[2B+D],
    new_acc)``, laid out as ``ops.predict.packed_layout`` slices it."""

    def predict(
        qparams: dict[str, Any],
        monitor: MonitorState,
        acc: MonitorAccumulator,
        temperature: torch.Tensor,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        mask: torch.Tensor,
    ):
        preds, flags, drift = quant_fused(
            qparams, monitor, temperature,
            cat_ids[None], numeric[None], mask[None],
        )
        packed = torch.cat([preds[0], flags[0], drift[0]])
        return packed, fold_accumulator(acc, flags[0], drift[0], mask)

    return predict


def make_quant_grouped_base() -> Callable:
    """Grouped packed program: inputs ``[S, R, ...]`` -> ``(packed
    f32[S, 2R+D], new_acc)`` in one kernel launch, the accumulator folded
    over the non-empty slots."""

    def grouped(
        qparams: dict[str, Any],
        monitor: MonitorState,
        acc: MonitorAccumulator,
        temperature: torch.Tensor,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        mask: torch.Tensor,
    ):
        preds, flags, drift = quant_fused(
            qparams, monitor, temperature, cat_ids, numeric, mask
        )
        packed = torch.cat([preds, flags, drift], dim=1)
        return packed, fold_accumulator_grouped(acc, flags, drift, mask)

    return grouped
