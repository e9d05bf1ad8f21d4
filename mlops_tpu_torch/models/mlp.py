"""Embedding-MLP and linear tabular classifiers: the exact tier's models.

Port of the JAX package's ``models/mlp.py`` on the flax-semantics layers
of ``models/layers.py``: Dense kernels ``[in, out]``, LayerNorm with eps
1e-6 and f32 statistics, ``nn.gelu``'s tanh approximation, compute in the
model's type (bf16 by default) over f32 parameters, the logit cast to
f32. ``forward(cat_ids, numeric, train=False, generator=None)`` is the
zoo's calling convention: with ``train`` and the trainer's generator the
MLP drops out after each block's GELU (``dropout``), as the flax module
does; the linear model has no dropout. Submodules carry flax's names (``CategoricalEmbed_0``, ``embed_j``,
``stem``, ``ln_i``, ``dense_ia``/``dense_ib``, ``ln_out``, ``head``), so a
flax param tree flattened with ``.`` is the module's ``state_dict``.

``members=K`` stacks every parameter on a leading ``[K, ...]`` axis (the
layout of the JAX ``DeepEnsemble``'s ``nn.vmap``) and returns logits
``[K, N]``: each layer is one batched product over the members.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlops_tpu_torch.models.layers import Dense, Embed, LayerNorm, dropout


class CategoricalEmbed(nn.Module):
    """One table per categorical feature (``embed_j``, cardinality from
    the schema, OOV bucket included), looked up and concatenated:
    ``[N, C] -> [(K,) N, C*E]``."""

    def __init__(
        self, cards: Sequence[int], embed_dim: int, dtype: torch.dtype, members: int = 0
    ) -> None:
        super().__init__()
        self.n = len(cards)
        for j, card in enumerate(cards):
            self.add_module(f"embed_{j}", Embed(card, embed_dim, dtype, members))

    def forward(self, cat_ids: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [getattr(self, f"embed_{j}")(cat_ids[:, j]) for j in range(self.n)], dim=-1
        )


def _inputs(
    embed: CategoricalEmbed,
    cat_ids: torch.Tensor,
    numeric: torch.Tensor,
    dtype: torch.dtype,
    members: int,
) -> torch.Tensor:
    """Embedded categoricals ‖ numerics in the model's type; every member
    sees the same rows."""
    cat = embed(cat_ids)
    num = numeric.to(dtype)
    if members:
        num = num.expand(members, *num.shape)
    return torch.cat([cat, num], dim=-1)


class LinearModel(nn.Module):
    """Logistic regression over scalar categorical embeds and the
    numerics: ``head(embeds ‖ numeric)``."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        dtype: torch.dtype = torch.bfloat16,
        members: int = 0,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.members = members
        self.CategoricalEmbed_0 = CategoricalEmbed(cards, 1, dtype, members)
        self.head = Dense((len(cards) + num_numeric, 1), (1,), dtype, members=members)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        x = _inputs(self.CategoricalEmbed_0, cat_ids, numeric, self.dtype, self.members)
        return self.head(x)[..., 0].float()


class MLP(nn.Module):
    """Residual MLP: a stem to ``hidden_dims[0]``, then per width a pre-LN
    block ``x + dense_ib(gelu(dense_ia(ln_i(x))))`` that projects back to
    ``hidden_dims[0]``, a final LayerNorm and the head."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        embed_dim: int = 16,
        hidden_dims: Sequence[int] = (256, 256, 128),
        dtype: torch.dtype = torch.bfloat16,
        members: int = 0,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.members = members
        self.dropout = dropout
        self.depth = len(hidden_dims)
        width0 = hidden_dims[0]
        self.CategoricalEmbed_0 = CategoricalEmbed(cards, embed_dim, dtype, members)
        d_in = len(cards) * embed_dim + num_numeric
        self.stem = Dense((d_in, width0), (width0,), dtype, members=members)
        for i, width in enumerate(hidden_dims):
            self.add_module(f"ln_{i}", LayerNorm(width0, dtype, members=members))
            self.add_module(
                f"dense_{i}a", Dense((width0, width), (width,), dtype, members=members)
            )
            self.add_module(
                f"dense_{i}b", Dense((width, width0), (width0,), dtype, members=members)
            )
        self.ln_out = LayerNorm(width0, dtype, members=members)
        self.head = Dense((width0, 1), (1,), dtype, members=members)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        gen = generator if train else None
        x = _inputs(self.CategoricalEmbed_0, cat_ids, numeric, self.dtype, self.members)
        x = self.stem(x)
        for i in range(self.depth):
            h = getattr(self, f"ln_{i}")(x)
            dense_a = getattr(self, f"dense_{i}a")
            h = F.gelu(dense_a(h), approximate="tanh")
            h = dropout(h, self.dropout, gen, rows=-2,
                        split=-1 if dense_a.tp is not None else None)
            x = x + getattr(self, f"dense_{i}b")(h)
        return self.head(self.ln_out(x))[..., 0].float()
