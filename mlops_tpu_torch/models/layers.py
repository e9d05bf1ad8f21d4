"""Layers with flax's semantics: Dense, Embed, LayerNorm, self-attention.

Port of the JAX package's ``models/layers.py`` plus the flax layers the
zoo builds on; with dropout 0 (the doc model's) training runs these same
forwards under autograd. Parameters are f32 and named as flax names
them (``kernel``, ``bias``, ``embedding``, ``scale``), so a flax param
tree flattened with ``.`` is the module's ``state_dict``. Compute runs in
the model's type (``dtype``): inputs, kernels and biases are cast to it,
a product is rounded to it before its bias is added, as flax's
``promote_dtype`` + ``dot_general`` + ``y += bias`` do. LayerNorm keeps
its statistics in f32 (eps 1e-6, flax's fast variance) and returns the
model's type.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from mlops_tpu_torch.ops.attention import attend


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral`` over a 2-D input. The
    kernel's leading ``in_features`` elements (one axis or several) are
    contracted with the input's last axis; its trailing axes, like the
    bias, are the output."""

    def __init__(
        self,
        kernel_shape: tuple[int, ...],
        bias_shape: tuple[int, ...],
        dtype: torch.dtype,
        in_features: int | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.in_features = in_features or kernel_shape[0]
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel.to(self.dtype).reshape(self.in_features, -1)
        y = torch.matmul(x.to(self.dtype), kernel)
        return y + self.bias.to(self.dtype).reshape(-1)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to the model's type, then a
    gather."""

    def __init__(self, num: int, features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros((num, features)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[ids]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6): mean and ``E[x^2] - E[x]^2``
    variance in f32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    f32, the result cast to the model's type."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-6) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention through ``ops.attention.attend`` (the dense reference
    at short sequence, the flash kernels at ``S >= 128`` on the card; under
    autograd the flash route's backward is the two backward kernels).

    ``qkv`` is a DenseGeneral with kernel ``[dim, 3, heads, head_dim]`` and
    bias ``[3, heads, head_dim]``; ``out`` has kernel ``[heads, head_dim,
    dim]``. q, k and v reach the kernel as strided views of the qkv
    projection. The ring (``attend_fn``) and padding masks belong to the
    sequence-parallel path and the masked dense path, which are not
    ported, and are refused."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dtype: torch.dtype,
        use_flash: bool | None = None,
        attend_fn: Callable | None = None,
    ) -> None:
        super().__init__()
        if attend_fn is not None:
            raise ValueError(
                "attend_fn (ring attention) is not ported: the port's "
                "attention is the dense dispatcher only"
            )
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.heads = heads
        self.head_dim = dim // heads
        self.use_flash = use_flash  # None = dispatch on device and length
        self.qkv = Dense(
            (dim, 3, heads, self.head_dim), (3, heads, self.head_dim), dtype
        )
        self.out = Dense(
            (heads, self.head_dim, dim), (dim,), dtype,
            in_features=heads * self.head_dim,
        )

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        if mask is not None:
            raise ValueError(
                "padding masks are not ported: they need the masked dense "
                "attention path"
            )
        n, s, dim = x.shape
        qkv = self.qkv(x.reshape(n * s, dim)).reshape(
            n, s, 3, self.heads, self.head_dim
        )
        out = attend(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], use_flash=self.use_flash
        )
        return self.out(out.reshape(n * s, dim)).reshape(n, s, dim)
