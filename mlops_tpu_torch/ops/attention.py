"""Attention: the dense reference and the flash-attention forward kernel.

Port of the JAX package's ``ops/attention.py`` (inference half). Layout
is the JAX one, ``[batch, seq, heads, head_dim]``, at every public
function.

- ``reference_attention``: dense softmax attention, scores in the input
  type then an f32 softmax, as the JAX reference computes it. The route
  for short sequences (``S < FLASH_MIN_SEQ``), on the card as on the TPU.
- ``flash_attention``: the online-softmax forward. On a CUDA tensor it
  launches ``csrc/flash_attention.cu`` (the Hopper counterpart of the
  Pallas ``_flash_kernel``) or raises; on a CPU tensor it runs
  ``flash_forward_reference``, the kernel's plain PyTorch version.
- ``attend``: the dispatch rule of the JAX package with the card in the
  TPU's place.

The backward kernels (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``)
are not ported yet: this module serves inference only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mlops_tpu_torch.ops.cuda_build import (
    PACKAGE_DIR,
    KernelLibrary,
    LaunchCounter,
)

KERNEL_SOURCE = PACKAGE_DIR / "csrc" / "flash_attention.cu"
# Where the Pallas kernel this one replaces lives in the JAX package.
REPLACES = "mlops_tpu/ops/attention.py:71"

# At or above this sequence length attention runs the flash kernel on the
# card; below it the dense reference (the JAX package's rule on the TPU).
FLASH_MIN_SEQ = 128

KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

flash_kernel_launches = LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 5 + [i64] * 12 + [i32] * 6 + [ctypes.c_float, ptr]
    )
    lib.flash_attention_launch.restype = ctypes.c_int


_LIBRARY = KernelLibrary(KERNEL_SOURCE, "flash_attention", _bind)
# Build (first use only) and load the kernel's shared library.
load_library = _LIBRARY.load


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Dense softmax attention, ``[B,S,H,D] -> [B,S,H,D]``: scores in the
    input type, an f32 softmax, probabilities cast to v's type for the PV
    product (the JAX ``reference_attention``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(q, scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``(out [B,S_q,H,D] in q's type,
    lse f32 [B*H, S_q])``.

    The arithmetic of the Pallas ``_flash_kernel`` in one pass: scores are
    an f32 product of the inputs times ``scale``, the softmax keeps f32
    statistics, p is cast to v's type for the PV product while the
    normalizer sums it in f32, and ``lse = m + log(max(l, 1e-30))``. The
    TPU kernel masks the keys it padded past ``kv_len``; here, as in the
    CUDA kernel, no key is padded, so every key of ``k`` counts.
    """
    b, s_q, h, d = q.shape
    qf = q.float().permute(0, 2, 1, 3)  # [B,H,Sq,D]
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * _scale(q, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(
        p.to(v.dtype).float(), v.float().permute(0, 2, 1, 3)
    )  # [B,H,Sq,D]
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out, lse.reshape(b * h, s_q)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def flash_forward_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention.cu`` on the current stream: same
    arguments and results as ``flash_forward_reference``. Takes strided
    ``[B,S,H,D]`` views (the head dimension contiguous, pointers and
    strides 16-byte aligned), bf16 or f32, head_dim 16, 32 or 64."""
    _check_inputs(q, k, v)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_forward_cuda takes CUDA tensors, got {device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes bf16 or f32, got {q.dtype}")
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernel is compiled for head_dim {KERNEL_HEAD_DIMS}, got {d}"
        )
    if b * h > 2**31 - 1 or min(s_q, s_kv) < 1:
        raise ValueError(f"unsupported launch: B*H={b * h}, S_q={s_q}, S_kv={s_kv}")
    elsize = q.element_size()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
        if t.data_ptr() % 16 or any(
            (st * elsize) % 16 for st in t.stride()[:3]
        ):
            raise ValueError(
                f"{name} must be 16-byte aligned (pointer and strides)"
            )
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=device)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=device)
    launch(q, k, v, out, lse, scale)
    return out, lse


def launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    scale: float | None = None,
) -> None:
    """One launch of the kernel into preallocated ``out`` ``[B,S_q,H,D]``
    and ``lse`` ``[B*H,S_q]``, on the current stream of the tensors' card;
    counts the launch. The inputs are those ``flash_forward_cuda`` has
    checked (benchmarks call this directly to time the device alone)."""
    b, s_q, h, d = q.shape
    lib = load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            b, h, s_q, k.shape[1], d, _DTYPE_CODES[q.dtype], _scale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_kernel_launches.add()


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Flash attention, ``[B,S,H,D] -> [B,S,H,D]`` (self- or cross-),
    routed by device: the plain version for tensors on the CPU, the CUDA
    kernel (or an error) for tensors on the card."""
    if q.device.type == "cpu":
        _check_inputs(q, k, v)
        return flash_forward_reference(q, k, v, scale)[0]
    return flash_forward_cuda(q, k, v, scale)[0]


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """The flash kernel for long sequences on the card, the dense
    reference otherwise. ``use_flash=None`` decides by device and
    ``S >= FLASH_MIN_SEQ``; ``True`` forces the flash route anywhere (on
    the CPU that is its plain version), ``False`` the dense one."""
    if use_flash is None:
        use_flash = q.device.type == "cuda" and q.shape[1] >= FLASH_MIN_SEQ
    if use_flash:
        return flash_attention(q, k, v, scale)
    return reference_attention(q, k, v, scale)
