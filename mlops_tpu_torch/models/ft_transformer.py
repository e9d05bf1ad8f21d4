"""The pre-LN transformer block of the JAX package's ``models/ft_transformer.py``
(``TransformerBlock`` without dropout). The FT-Transformer itself and its
``FeatureTokenizer`` are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlops_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadSelfAttention


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + MHA(LN(x))``, then ``x + FFN(LN(x))`` with a
    4x GELU (tanh approximation, flax's default) FFN on ``[N*S, D]``.
    Submodules carry flax's auto-names, so the param tree maps 1:1."""

    def __init__(self, heads: int, token_dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.LayerNorm_0 = LayerNorm(token_dim, dtype)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(token_dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(token_dim, dtype)
        self.Dense_0 = Dense((token_dim, 4 * token_dim), (4 * token_dim,), dtype)
        self.Dense_1 = Dense((4 * token_dim, token_dim), (token_dim,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x))
        h = self.LayerNorm_1(x)
        n, s, d = h.shape
        h = self.Dense_0(h.reshape(n * s, d))
        h = self.Dense_1(F.gelu(h, approximate="tanh"))
        return x + h.reshape(n, s, d)
