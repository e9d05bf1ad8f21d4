"""The mixture-of-experts transformer of the JAX package's
``models/moe.py`` (family ``moe``): the FT-Transformer body with every
block's FFN a top-2 gated mixture of experts.

- **The router** is a Dense to the E experts in f32 over the tokens cast
  to f32 (a softmax over expert logits is sensitive to precision), its
  softmax the gates. The k = min(2, E) largest gates pick the experts;
  the routing mask is the sum of their one-hots, the combine weights
  ``gates * mask / (sum + 1e-9)``.
- **Dense dispatch**: every expert runs on every token, as two products
  over the ``[N*S, D]`` tokens (``td,edf->tef`` and ``tef,efd->ted``) in
  the model's type, and the combine ``te,ted->td`` zeroes the experts a
  token was not routed to. No shape depends on the routing and nothing
  is read back to the host, so the forward captures in a CUDA graph at
  every bucket. At 24 tokens a row the E-fold products are far cheaper
  than a gather and scatter; the JAX package runs them outside any
  Pallas kernel, and so does this one (``torch.einsum``).
- **The auxiliary**: in training each block's Switch load-balance loss
  ``aux_weight * E * sum(importance * load)`` (``importance`` the mean
  gate per expert, ``load`` the mean of ``mask / k``) comes back from the
  forward beside the logits, ``(logits, aux [(K,) depth])``; the trainer
  adds the mean of each block's (``train/loop.py``). Eval computes none
  and returns the logits alone.

Names follow the flax tree (``FeatureTokenizer_0``; ``block_i`` with
``LayerNorm_0``, ``MultiHeadSelfAttention_0``, ``LayerNorm_1`` and
``MoEFeedForward_0`` holding ``router`` and the raw ``experts_in``,
``experts_in_bias``, ``experts_out``, ``experts_out_bias``; ``ln_final``;
``head``). ``members=K`` is the member of a deep ensemble: a leading
``[K, ...]`` axis on every parameter (the experts ``[K, E, D, F]``), the
logits ``[K, N]`` and the auxiliary ``[K, depth]``, as flax's ``nn.vmap``
stacks the sown values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlops_tpu_torch.models.ft_transformer import FeatureTokenizer, apply_ft_head
from mlops_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadSelfAttention,
    TPSplit,
    dropout,
)
from mlops_tpu_torch.parallel.collectives import copy_to, pmean, reduce_from, take_shard


class MoEFeedForward(nn.Module):
    """Top-k gated expert FFN with dense dispatch: ``x [(K,) N, S, D] ->
    (out [(K,) N, S, D], aux [(K,)] in training, else None)``.

    Split over 'model' (``tp``, ``parallel/steps.py``) the rank holds
    E/ep experts: the router and its gates stay replicated, the dispatch
    products run this rank's experts and the combine is all-reduced.
    Under data parallelism (``data_group``) the auxiliary's importance
    and load are means over the whole logical batch, as the JAX step
    computes them."""

    def __init__(
        self,
        num_experts: int,
        token_dim: int,
        dtype: torch.dtype,
        hidden_mult: int = 4,
        top_k: int = 2,
        aux_weight: float = 0.01,
        members: int = 0,
    ) -> None:
        super().__init__()
        e, d, f = num_experts, token_dim, hidden_mult * token_dim
        self.num_experts = e
        self.k = min(top_k, e)
        self.aux_weight = aux_weight
        self.dtype = dtype
        lead = (members,) if members else ()
        self.router = Dense((d, e), (e,), torch.float32, members=members)
        self.experts_in = nn.Parameter(torch.zeros(lead + (e, d, f)))
        self.experts_in_bias = nn.Parameter(torch.zeros(lead + (e, f)))
        self.experts_out = nn.Parameter(torch.zeros(lead + (e, f, d)))
        self.experts_out_bias = nn.Parameter(torch.zeros(lead + (e, d)))
        self.tp: TPSplit | None = None
        self.data_group = None

    def route(
        self, tokens: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``tokens [(K,) T, D] ->`` the f32 gates, the routing mask (1 on
        each token's k chosen experts) and the combine weights, each
        ``[(K,) T, E]``."""
        gates = torch.softmax(self.router(tokens.float()), dim=-1)
        top = torch.topk(gates, self.k, dim=-1).indices
        experts = torch.arange(self.num_experts, device=tokens.device)
        mask = (top[..., None] == experts).to(gates.dtype).sum(-2)
        weights = gates * mask
        return gates, mask, weights / (weights.sum(-1, keepdim=True) + 1e-9)

    def forward(
        self, x: torch.Tensor, train: bool
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        *lead, n, s, d = x.shape
        e, k = self.num_experts, self.k
        tokens = x.reshape(*lead, n * s, d)
        gates, mask, weights = self.route(tokens)

        aux = None
        if train:
            importance = gates.mean(dim=-2)  # [(K,) E] mean router prob
            load = (mask / k).mean(dim=-2)  # [(K,) E] fraction routed
            if self.data_group is not None:
                importance = pmean(importance, self.data_group, terms=True)
                load = pmean(load, self.data_group, terms=True)
            aux = self.aux_weight * (e * torch.sum(importance * load, dim=-1))

        dt = self.dtype
        xb = tokens.to(dt)
        tp = self.tp
        if tp is not None:
            xb = copy_to(xb, tp.group)
            weights = take_shard(weights, -1, tp.group)
        h = torch.einsum("...td,...edf->...tef", xb, self.experts_in.to(dt))
        h = F.gelu(h + self.experts_in_bias.to(dt).unsqueeze(-3), approximate="tanh")
        y = torch.einsum("...tef,...efd->...ted", h, self.experts_out.to(dt))
        y = y + self.experts_out_bias.to(dt).unsqueeze(-3)
        out = torch.einsum("...te,...ted->...td", weights.to(dt), y)
        if tp is not None:
            out = reduce_from(out, tp.group)
        return out.reshape(x.shape), aux


class MoEBlock(nn.Module):
    """Pre-LN block: ``x + dropout(MHA(LN(x)))``, then ``x +
    dropout(MoE(LN(x)))``; returns the block's output and its auxiliary
    (None in eval)."""

    def __init__(
        self,
        heads: int,
        token_dim: int,
        num_experts: int,
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
        self.MoEFeedForward_0 = MoEFeedForward(
            num_experts, token_dim, dtype, members=members
        )

    def forward(
        self, x: torch.Tensor, train: bool, generator: torch.Generator | None = None
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        h = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), generator=generator)
        x = x + dropout(h, self.dropout, generator, rows=-3)
        h, aux = self.MoEFeedForward_0(self.LayerNorm_1(x), train)
        return x + dropout(h, self.dropout, generator, rows=-3), aux


class MoETransformer(nn.Module):
    """``(cat_ids, numeric) -> logits f32 [(K,) N]`` in eval, ``(logits,
    aux [(K,) depth])`` in training."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        token_dim: int = 64,
        depth: int = 3,
        heads: int = 8,
        num_experts: int = 8,
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
                f"block_{i}",
                MoEBlock(heads, token_dim, num_experts, dtype, dropout, members),
            )
        self.ln_final = LayerNorm(token_dim, dtype, members=members)
        self.head = Dense((token_dim, 1), (1,), dtype, members=members)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        gen = generator if train else None
        x = self.FeatureTokenizer_0(cat_ids, numeric)
        aux = []
        for i in range(self.depth):
            x, block_aux = getattr(self, f"block_{i}")(x, train, gen)
            aux.append(block_aux)
        logits = apply_ft_head(self, x)
        return (logits, torch.stack(aux, dim=-1)) if train else logits
