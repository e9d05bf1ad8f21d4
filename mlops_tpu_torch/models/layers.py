"""Layers with flax's semantics: Dense, Embed, LayerNorm, dropout and
self-attention.

Port of the JAX package's ``models/layers.py`` plus the flax layers the
zoo builds on; training runs these same forwards under autograd, with
dropout drawn from a ``torch.Generator`` the trainer passes in (eval
passes none). Parameters are f32 and named as flax names
them (``kernel``, ``bias``, ``embedding``, ``scale``), so a flax param
tree flattened with ``.`` is the module's ``state_dict``. Compute runs in
the model's type (``dtype``): inputs, kernels and biases are cast to it,
a product is rounded to it before its bias is added, as flax's
``promote_dtype`` + ``dot_general`` + ``y += bias`` do. LayerNorm keeps
its statistics in f32 (eps 1e-6, flax's fast variance) and returns the
model's type.

``members=K`` gives every layer here a leading ``[K, ...]`` axis on
every parameter, the layout of the JAX package's ``nn.vmap`` deep
ensemble: one batched product per layer over the K members, the input
shared (``[N, F]``) or per member (``[K, N, F]``; LayerNorm takes any
``[K, ..., F]``). Self-attention folds the members into the batch before
``attend``.

Tensor parallelism (``parallel/steps.py::shard_model``) sets a layer's
``tp``: a column-split Dense holds its kernel's output slice and takes
its bias's (the input enters through ``copy_to``), a row-split Dense
holds its input slice and all-reduces its product before the bias, and
self-attention runs this rank's heads. Unset, every layer is the plain
one. ``dropout`` takes the axes a layout stream needs to draw the whole
logical mask and keep this rank's block of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from mlops_tpu_torch.ops.attention import attend
from mlops_tpu_torch.parallel.collectives import copy_to, reduce_from, take_shard


@dataclasses.dataclass(frozen=True)
class TPSplit:
    """How a layer is split over the mesh's 'model' axis: ``kind``
    "column" (output features; ``bias_dim``: the bias dimension split
    with them), "row" (input features) or "heads"; ``group`` the axis's
    process group, ``size`` and ``index`` this rank's place on it."""

    kind: str
    group: object
    size: int
    index: int
    bias_dim: int = -1


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
        members: int = 0,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.in_features = in_features or kernel_shape[0]
        self.lead = (members,) if members else ()
        self.kernel = nn.Parameter(torch.zeros(self.lead + tuple(kernel_shape)))
        self.bias = nn.Parameter(torch.zeros(self.lead + tuple(bias_shape)))
        self.tp: TPSplit | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is not None and tp.kind == "column":
            x = copy_to(x, tp.group)
        kernel = self.kernel.to(self.dtype).reshape(*self.lead, self.in_features, -1)
        y = torch.matmul(x.to(self.dtype), kernel)
        bias = self.bias
        if tp is not None:
            if tp.kind == "column":
                bias = take_shard(bias, tp.bias_dim, tp.group)
            else:
                y = reduce_from(y, tp.group)
        bias = bias.to(self.dtype)
        return y + (bias.reshape(*self.lead, 1, -1) if self.lead else bias.reshape(-1))


class Embed(nn.Module):
    """flax ``nn.Embed``: the table's rows in the model's type. The rows
    are gathered and then cast, which gives flax's values (it casts the
    table, then gathers) and lets the gradient of a row that many ids hit
    accumulate in f32."""

    def __init__(
        self, num: int, features: int, dtype: torch.dtype, members: int = 0
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.members = members
        lead = (members,) if members else ()
        self.embedding = nn.Parameter(torch.zeros(lead + (num, features)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.embedding[:, ids] if self.members else self.embedding[ids]
        return rows.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6): mean and ``E[x^2] - E[x]^2``
    variance in f32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    f32, the result cast to the model's type."""

    def __init__(
        self, features: int, dtype: torch.dtype, eps: float = 1e-6, members: int = 0
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.lead = (members,) if members else ()
        self.scale = nn.Parameter(torch.ones(self.lead + (features,)))
        self.bias = nn.Parameter(torch.zeros(self.lead + (features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        scale, bias = self.scale, self.bias
        if self.lead:  # [K, F] -> [K, 1, ..., F] over the members' rows
            shape = self.lead + (1,) * (x.dim() - 2) + scale.shape[-1:]
            scale, bias = scale.reshape(shape), bias.reshape(shape)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        return y.to(self.dtype)


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: torch.Generator | None,
    rows: int = 0,
    split: int | None = None,
) -> torch.Tensor:
    """flax ``nn.Dropout``: with a generator (training), keep each element
    with probability ``1 - rate`` and divide the kept ones by ``1 - rate``
    in the tensor's own type; without one (eval), or at rate 0, ``x`` as it
    is. One draw covers the whole tensor, so the members of an ensemble
    (a leading ``[K, ...]`` axis) draw masks of their own. ``generator``
    is a ``torch.Generator`` or a stream with ``uniform(shape, device,
    rows, split)``: ``train/hpo.py``'s ``CounterStream``, which runs under
    ``torch.func.vmap``, where a generator cannot, or a layout's
    ``ShardedStream`` (``parallel/steps.py``), which draws the mask of the
    whole logical activation and keeps this rank's block: the rows of
    axis ``rows`` it holds under data parallelism, the features of axis
    ``split`` under tensor parallelism."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if isinstance(generator, torch.Generator):
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = generator.uniform(x.shape, x.device, rows, split)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class MultiHeadSelfAttention(nn.Module):
    """Self-attention through ``ops.attention.attend`` (the dense reference
    at short sequence, the flash kernels at ``S >= 128`` on the card; under
    autograd the flash route's backward is the two backward kernels).

    ``qkv`` is a DenseGeneral with kernel ``[dim, 3, heads, head_dim]`` and
    bias ``[3, heads, head_dim]``; ``out`` has kernel ``[heads, head_dim,
    dim]``. q, k and v reach the kernel as strided views of the qkv
    projection. With attention-weight dropout in training (``dropout >
    0`` and a generator) the scores are materialized instead, as the JAX
    module does, on the CPU and the card alike: ``einsum(q, k)`` in f32
    times the scale, a softmax, dropout on the probabilities, which are
    cast to v's type for ``einsum(p, v)``. ``attend_fn(q, k, v)``
    replaces ``attend`` (the ring of ``parallel/ring_attention.py`` on a
    sequence-parallel mesh; it never materializes the scores, so it
    takes no attention-weight dropout). Padding masks belong to the
    masked dense path, which is not ported, and are refused. With
    ``members=K`` the input is ``[K, N, S, dim]`` and the K members'
    sequences are one batch of ``K * N`` for the attention itself. Split
    by heads (``tp``), ``heads`` counts this rank's."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dtype: torch.dtype,
        use_flash: bool | None = None,
        attend_fn: Callable | None = None,
        dropout: float = 0.0,
        members: int = 0,
    ) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.heads = heads
        self.head_dim = dim // heads
        self.use_flash = use_flash  # None = dispatch on device and length
        self.attend_fn = attend_fn
        self.dropout = dropout
        self.tp: TPSplit | None = None
        self.qkv = Dense(
            (dim, 3, heads, self.head_dim), (3, heads, self.head_dim), dtype,
            members=members,
        )
        self.out = Dense(
            (heads, self.head_dim, dim), (dim,), dtype,
            in_features=heads * self.head_dim, members=members,
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        if mask is not None:
            raise ValueError(
                "padding masks are not ported: they need the masked dense "
                "attention path"
            )
        lead = x.shape[:-3]  # (K,) with members
        n, s, dim = x.shape[-3:]
        qkv = self.qkv(x.reshape(*lead, n * s, dim)).reshape(
            -1, s, 3, self.heads, self.head_dim
        )
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.dropout > 0.0 and generator is not None:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
                1.0 / math.sqrt(self.head_dim)
            )
            probs = torch.softmax(scores, dim=-1)
            # [*lead, n, heads, s, s]: the rows and this rank's heads.
            probs = dropout(
                probs.reshape(*lead, n, *probs.shape[1:]), self.dropout, generator,
                rows=-4, split=-3 if self.tp is not None else None,
            ).reshape(probs.shape)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        elif self.attend_fn is not None:
            out = self.attend_fn(q, k, v)
        else:
            out = attend(q, k, v, use_flash=self.use_flash)
        return self.out(out.reshape(*lead, n * s, -1)).reshape(*lead, n, s, dim)
