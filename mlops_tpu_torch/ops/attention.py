"""Attention: the dense reference and flash attention, forward and
backward.

Port of the JAX package's ``ops/attention.py``. Layout is the JAX one,
``[batch, seq, heads, head_dim]``, at every public function.

- ``reference_attention``: dense softmax attention, scores in the input
  type then an f32 softmax, as the JAX reference computes it. The route
  for short sequences (``S < FLASH_MIN_SEQ``), on the card as on the TPU;
  autograd differentiates it.
- ``flash_attention``: the online-softmax forward and, when a gradient is
  wanted, its backward, through ``FlashAttention`` (the
  ``torch.autograd.Function`` in the place of the JAX ``custom_vjp``).
  On CUDA tensors the forward launches ``csrc/flash_attention.cu`` (the
  Hopper counterpart of the Pallas ``_flash_kernel``) and the backward
  the two kernels of ``csrc/flash_attention_bwd.cu`` (``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel``), or raise; on CPU tensors each runs its
  plain PyTorch version (``flash_forward_reference``,
  ``flash_backward_reference``).
- ``attend``: the dispatch rule of the JAX package with the card in the
  TPU's place.
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
BWD_KERNEL_SOURCE = PACKAGE_DIR / "csrc" / "flash_attention_bwd.cu"
# Where the Pallas kernels these replace live in the JAX package.
REPLACES = "mlops_tpu/ops/attention.py:71"
BWD_DQ_REPLACES = "mlops_tpu/ops/attention.py:206"
BWD_DKV_REPLACES = "mlops_tpu/ops/attention.py:247"

# At or above this sequence length attention runs the flash kernel on the
# card; below it the dense reference (the JAX package's rule on the TPU).
FLASH_MIN_SEQ = 128

# The head dims the three kernels are compiled for. The JAX package sets
# no bound; a model whose attention would reach the kernels at another
# head_dim is refused where it is built (``check_flash_head_dim``).
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

flash_kernel_launches = LaunchCounter()
flash_bwd_dq_launches = LaunchCounter()
flash_bwd_dkv_launches = LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 5 + [i64] * 12 + [i32] * 6 + [ctypes.c_float, ptr]
    )
    lib.flash_attention_launch.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tail = [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_attention_bwd_dq_launch.argtypes = [ptr] * 7 + [i64] * 15 + tail
    lib.flash_attention_bwd_dq_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_dkv_launch.argtypes = [ptr] * 8 + [i64] * 18 + tail
    lib.flash_attention_bwd_dkv_launch.restype = ctypes.c_int


_LIBRARY = KernelLibrary(KERNEL_SOURCE, "flash_attention", _bind)
_BWD_LIBRARY = KernelLibrary(BWD_KERNEL_SOURCE, "flash_attention_bwd", _bind_bwd)
# Build (first use only) and load each source's shared library.
load_library = _LIBRARY.load
load_bwd_library = _BWD_LIBRARY.load


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _wide(x: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: f32 for bf16 and f32 inputs (as
    the kernels accumulate), f64 for f64 (``gradcheck``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """``[B,S,H,D]`` -> ``[B,H,S,D]`` in the working type."""
    return _wide(x).permute(0, 2, 1, 3)


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
    """The forward kernel's plain version: ``(out [B,S_q,H,D] in q's type,
    lse f32 [B*H, S_q])``.

    The arithmetic of the Pallas ``_flash_kernel`` in one pass: scores are
    an f32 product of the inputs times ``scale``, the softmax keeps f32
    statistics, p is cast to v's type for the PV product while the
    normalizer sums it in f32, and ``lse = m + log(max(l, 1e-30))``. The
    TPU kernel masks the keys it padded past ``kv_len``; here, as in the
    CUDA kernel, no key is padded, so every key of ``k`` counts.
    """
    b, s_q, h, d = q.shape
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2))
    s = s * _scale(q, scale)  # [B,H,Sq,Skv]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(_wide(p.to(v.dtype)), _heads_first(v))  # [B,H,Sq,D]
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out, lse.reshape(b * h, s_q)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta_i = do_i . out_i`` in f32, ``[B*H, S_q]``: the softmax
    Jacobian's correction term, one plain reduction outside both backward
    kernels (as the JAX package computes it in XLA)."""
    b, s_q, h, _ = out.shape
    delta = (_wide(do) * _wide(out)).sum(dim=-1)  # [B, S_q, H]
    return delta.transpose(1, 2).reshape(b * h, s_q).contiguous()


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version: ``(dq, dk, dv)`` in q's, k's
    and v's types from the forward's ``out`` and ``lse`` and the output
    gradient ``do``.

    The arithmetic of the Pallas ``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel`` in one pass: ``p = exp(s - lse)`` recomputed
    from f32 scores, ``dp = do v^T`` in f32, ``ds = p (dp - delta) scale``;
    ``dq = ds k`` with ds rounded to k's type, ``dk = ds^T q`` with ds
    rounded to q's type, ``dv = p^T do`` with p rounded to do's type, all
    accumulated in f32 and rounded once to the output's type."""
    b, s_q, h, _ = q.shape
    sc = _scale(q, scale)
    qf, kf, vf, dof = (_heads_first(x) for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sc  # [B,H,Sq,Skv]
    p = torch.exp(s - lse.reshape(b, h, s_q, 1).to(s.dtype))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = flash_delta(out, do).reshape(b, h, s_q, 1)
    ds = p * (dp - delta) * sc

    def back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(like.dtype).permute(0, 2, 1, 3).contiguous()  # [B,S,H,D]

    dq = torch.matmul(_wide(ds.to(k.dtype)), kf)
    dk = torch.matmul(_wide(ds.to(q.dtype)).transpose(-1, -2), qf)
    dv = torch.matmul(_wide(p.to(do.dtype)).transpose(-1, -2), dof)
    return back(dq, q), back(dk, k), back(dv, v)


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


def _check_launchable(views: dict[str, torch.Tensor]) -> None:
    """What every kernel of this module needs of its CUDA arguments
    (``views`` by name, q and k among them): bf16 or f32, head_dim in
    ``KERNEL_HEAD_DIMS``, and each ``[B,S,H,D]`` view with its head dimension
    contiguous and its pointer and strides 16-byte aligned."""
    q, k = views["q"], views["k"]
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {q.device}")
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
    for name, t in views.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
        if t.data_ptr() % 16 or any((st * elsize) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned (pointer and strides)")


def _check_rows(lse: torch.Tensor, delta: torch.Tensor, q: torch.Tensor) -> None:
    b, s_q, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (
            t.shape != (b * h, s_q) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"{name} must be contiguous f32 [B*H, S_q] = [{b * h}, {s_q}] "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)}"
            )


def _strides(*tensors: torch.Tensor) -> list[int]:
    return [st for t in tensors for st in t.stride()[:3]]


def flash_forward_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention.cu`` on the current stream: same
    arguments and results as ``flash_forward_reference``. Takes strided
    ``[B,S,H,D]`` views (the head dimension contiguous, pointers and
    strides 16-byte aligned), bf16 or f32, head_dim in
    ``KERNEL_HEAD_DIMS``."""
    _check_inputs(q, k, v)
    _check_launchable({"q": q, "k": k, "v": v})
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
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
    """One launch of the forward kernel into preallocated ``out``
    ``[B,S_q,H,D]`` and ``lse`` ``[B*H,S_q]``, on the current stream of the
    tensors' card; counts the launch. The inputs are those
    ``flash_forward_cuda`` has checked (benchmarks call this directly to
    time the device alone)."""
    b, s_q, h, d = q.shape
    lib = load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_strides(q, k, v, out),
            b, h, s_q, k.shape[1], d, _DTYPE_CODES[q.dtype], _scale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_kernel_launches.add()


def flash_bwd_dq_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the dq kernel of ``csrc/flash_attention_bwd.cu``: dq
    ``[B,S_q,H,D]`` in q's type from strided views q, k, v and do (as
    ``flash_forward_cuda`` takes them) and f32 ``lse``/``delta``
    ``[B*H, S_q]``."""
    _check_inputs(q, k, v)
    _check_launchable({"q": q, "k": k, "v": v, "do": do})
    _check_rows(lse, delta, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_dq(q, k, v, do, lse, delta, dq, scale)
    return dq


def flash_bwd_dkv_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of ``csrc/flash_attention_bwd.cu``: (dk,
    dv) ``[B,S_kv,H,D]`` in k's and v's type; arguments as for
    ``flash_bwd_dq_cuda``."""
    _check_inputs(q, k, v)
    _check_launchable({"q": q, "k": k, "v": v, "do": do})
    _check_rows(lse, delta, q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch_dkv(q, k, v, do, lse, delta, dk, dv, scale)
    return dk, dv


def _bwd_tail(q: torch.Tensor, k: torch.Tensor, scale: float | None) -> list:
    b, s_q, h, d = q.shape
    return [
        b, h, s_q, k.shape[1], d, _DTYPE_CODES[q.dtype], _scale(q, scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ]


def launch_dq(q, k, v, do, lse, delta, dq, scale: float | None = None) -> None:
    """One launch of the dq kernel into a preallocated ``dq`` (a
    ``[B,S_q,H,D]`` view, checked as the inputs are); counts the launch."""
    lib = load_bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_strides(q, k, v, do, dq), *_bwd_tail(q, k, scale),
        )
    if err != 0:
        raise RuntimeError(f"flash backward dq kernel launch failed: cudaError {err}")
    flash_bwd_dq_launches.add()


def launch_dkv(q, k, v, do, lse, delta, dk, dv, scale: float | None = None) -> None:
    """One launch of the dk/dv kernel into preallocated ``dk`` and ``dv``;
    counts the launch."""
    lib = load_bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_strides(q, k, v, do, dk, dv), *_bwd_tail(q, k, scale),
        )
    if err != 0:
        raise RuntimeError(f"flash backward dk/dv kernel launch failed: cudaError {err}")
    flash_bwd_dkv_launches.add()


def flash_backward_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_backward_reference`` on the card: delta by one torch
    reduction, then the dq kernel and the dk/dv kernel."""
    delta = flash_delta(out, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


def _flash_forward(q, k, v, scale):
    """The forward by device: the plain version for CPU tensors, the
    kernel (or an error) for tensors on the card."""
    if q.device.type == "cpu":
        _check_inputs(q, k, v)
        return flash_forward_reference(q, k, v, scale)
    return flash_forward_cuda(q, k, v, scale)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the JAX ``custom_vjp``): the
    forward saves ``q, k, v, out, lse``; the backward recomputes the
    probabilities from ``lse``. Both run the kernels on CUDA tensors and
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = flash_backward_reference(q, k, v, out, lse, do, ctx.scale)
        else:
            grads = flash_backward_cuda(q, k, v, out, lse, do, ctx.scale)
        return (*grads, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Flash attention, ``[B,S,H,D] -> [B,S,H,D]`` (self- or cross-),
    routed by device: the plain versions for tensors on the CPU, the CUDA
    kernels (or an error) for tensors on the card. When autograd wants a
    gradient of q, k or v the call goes through ``FlashAttention``;
    otherwise (``no_grad``, ``inference_mode``, or inputs that need none)
    it is the forward alone and nothing is saved."""
    scale = _scale(q, scale)
    wants_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    )
    if wants_grad:
        return FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale)[0]


def check_flash_head_dim(head_dim: int, seq: int, device: torch.device | str) -> None:
    """Refuse, before any forward, a model whose attention at sequence
    length ``seq`` would reach the flash kernels on the card at a head_dim
    they are not compiled for (ROADMAP C1). On the CPU the plain route
    takes every head_dim, and short sequences take the dense route on the
    card too."""
    if (
        torch.device(device).type == "cuda"
        and seq >= FLASH_MIN_SEQ
        and head_dim not in KERNEL_HEAD_DIMS
    ):
        raise ValueError(
            f"head_dim {head_dim} has no flash-attention kernel on the card "
            f"(compiled for {KERNEL_HEAD_DIMS}; ROADMAP C1): pick token_dim "
            "and heads whose quotient is one of them, or run on the CPU"
        )


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """The flash kernels for long sequences on the card, the dense
    reference otherwise. ``use_flash=None`` decides by device and
    ``S >= FLASH_MIN_SEQ``; ``True`` forces the flash route anywhere (on
    the CPU that is its plain version), ``False`` the dense one."""
    if use_flash is None:
        use_flash = q.device.type == "cuda" and q.shape[1] >= FLASH_MIN_SEQ
    if use_flash:
        return flash_attention(q, k, v, scale)
    return reference_attention(q, k, v, scale)
