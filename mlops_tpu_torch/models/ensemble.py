"""The deep ensemble of the JAX package's ``models/ensemble.py``.

The JAX ``DeepEnsemble`` lifts a member with ``nn.vmap``: every parameter
gains a leading member axis and each layer is one batched matmul. Here
the member module is built with that axis (``members=K``: the mlp and
linear models, the FT-Transformer, the single-record BERT and the MoE,
whose attention folds the members into its batch) and held as
``member``, the flax tree's name, so the vmapped param tree maps 1:1.
Serving is eval: the logit of the mean member probability, the
probability clipped to ``[1e-7, 1 - 1e-7]``. Training returns the
member logits ``[K, N]``, with a moe member's auxiliaries ``[K,
blocks]`` beside them, stacked as flax's ``variable_axes={"aux_losses":
0}`` stacks the sown values.
"""

from __future__ import annotations

import torch
from torch import nn


class DeepEnsemble(nn.Module):
    """K members stacked on a leading axis: ``(cat_ids, numeric) ->
    logits [N]`` (f32) in eval, ``[K, N]`` in training (``(logits,
    aux)`` for a member with auxiliaries)."""

    def __init__(self, member: nn.Module, size: int) -> None:
        super().__init__()
        if getattr(member, "members", 0) != size:
            raise ValueError(f"the member must be built with members={size}")
        self.member = member
        self.size = size

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        logits = self.member(cat_ids, numeric, train, generator)  # [K, N]
        if train:
            return logits
        probs = torch.sigmoid(logits.float()).mean(dim=0)
        probs = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
        return torch.log(probs) - torch.log1p(-probs)
