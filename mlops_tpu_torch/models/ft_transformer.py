"""The FT-Transformer of the JAX package's ``models/ft_transformer.py``:
each of the 23 features becomes one token (categoricals by embedding
lookup, numerics as a learned per-feature direction scaled by the
standardized value), a CLS token leads, pre-LN ``TransformerBlock``s
follow (shared with the BERT models), and the head reads CLS.

Module and parameter names follow the flax tree (``FeatureTokenizer_0``
with ``cat_j``, ``num_weight``, ``num_bias`` and ``cls``; ``block_i``;
``ln_final``; ``head``). ``forward(cat_ids, numeric, train=False,
generator=None)``: with ``train`` and the trainer's generator the blocks
drop out after attention, on the attention weights and after the FFN's
GELU, as the flax blocks do. ``members=K`` builds the member of a deep
ensemble: every parameter gains a leading ``[K, ...]`` axis, the K
members read the same rows and return logits ``[K, N]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlops_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadSelfAttention,
    dropout,
)


class FeatureTokenizer(nn.Module):
    """``(cat_ids [N, C], numeric [N, M]) -> tokens [(K,) N, 1 + C + M,
    D]``: CLS, the C categorical lookups, then ``numeric * num_weight +
    num_bias`` per numeric feature, all in the model's type."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        token_dim: int,
        dtype: torch.dtype,
        members: int = 0,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.n = len(cards)
        self.lead = (members,) if members else ()
        for j, card in enumerate(cards):
            self.add_module(f"cat_{j}", Embed(card, token_dim, dtype, members))
        self.num_weight = nn.Parameter(torch.zeros(self.lead + (num_numeric, token_dim)))
        self.num_bias = nn.Parameter(torch.zeros(self.lead + (num_numeric, token_dim)))
        self.cls = nn.Parameter(torch.zeros(self.lead + (1, 1, token_dim)))

    def forward(self, cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
        n = cat_ids.shape[0]
        cat_tok = torch.stack(
            [getattr(self, f"cat_{j}")(cat_ids[:, j]) for j in range(self.n)], dim=-2
        )
        weight, bias = self.num_weight.to(self.dtype), self.num_bias.to(self.dtype)
        if self.lead:  # [K, M, D] -> [K, 1, M, D] over the shared rows
            weight, bias = weight.unsqueeze(-3), bias.unsqueeze(-3)
        num_tok = numeric[:, :, None].to(self.dtype) * weight + bias
        cls = self.cls.to(self.dtype).expand(*self.lead, n, 1, -1)
        return torch.cat([cls, cat_tok, num_tok], dim=-2)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + dropout(MHA(LN(x)))``, then ``x +
    FFN(LN(x))`` with a 4x GELU (tanh approximation, flax's default) FFN
    on ``[(K,) N*S, D]`` and dropout after the GELU. Submodules carry
    flax's auto-names, so the param tree maps 1:1."""

    def __init__(
        self,
        heads: int,
        token_dim: int,
        dtype: torch.dtype,
        dropout: float = 0.0,
        members: int = 0,
    ) -> None:
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(token_dim, dtype, members=members)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            token_dim, heads, dtype, dropout=dropout, members=members
        )
        self.LayerNorm_1 = LayerNorm(token_dim, dtype, members=members)
        self.Dense_0 = Dense(
            (token_dim, 4 * token_dim), (4 * token_dim,), dtype, members=members
        )
        self.Dense_1 = Dense(
            (4 * token_dim, token_dim), (token_dim,), dtype, members=members
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        h = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), generator=generator)
        x = x + dropout(h, self.dropout, generator, rows=-3)
        h = self.LayerNorm_1(x)
        *lead, n, s, d = h.shape
        h = F.gelu(self.Dense_0(h.reshape(*lead, n * s, d)), approximate="tanh")
        split = -1 if self.Dense_0.tp is not None else None
        h = self.Dense_1(dropout(h, self.dropout, generator, rows=-2, split=split))
        return x + h.reshape(x.shape)


def apply_ft_head(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The FT read-out: ``ln_final`` on CLS, the head logit, cast to f32."""
    return mod.head(mod.ln_final(x[..., 0, :]))[..., 0].float()


class FTTransformer(nn.Module):
    """``(cat_ids, numeric) -> logits f32 [N]`` over 24 tokens (dense
    attention: the sequence is far below the flash kernels' length)."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        token_dim: int = 64,
        depth: int = 3,
        heads: int = 8,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        members: int = 0,
    ) -> None:
        super().__init__()
        self.depth = depth
        self.members = members
        self.FeatureTokenizer_0 = FeatureTokenizer(
            cards, num_numeric, token_dim, dtype, members
        )
        for i in range(depth):
            self.add_module(
                f"block_{i}", TransformerBlock(heads, token_dim, dtype, dropout, members)
            )
        self.ln_final = LayerNorm(token_dim, dtype, members=members)
        self.head = Dense((token_dim, 1), (1,), dtype, members=members)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        gen = generator if train else None
        x = self.FeatureTokenizer_0(cat_ids, numeric)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, gen)
        return apply_ft_head(self, x)
