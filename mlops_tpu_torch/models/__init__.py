"""Model zoo (ported: the exact tier's linear, mlp and deep ensemble, and
the long-context document BERT).

``build_model`` is the JAX package's (``mlops_tpu/models/__init__.py``)
for the families the exact tier serves; the others are refused with the
ROADMAP item that ports them. Every model maps ``(cat_ids int32 [N, C],
numeric f32 [N, M]) -> logits f32 [N]``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.models.ensemble import DeepEnsemble
from mlops_tpu_torch.models.mlp import MLP, LinearModel
from mlops_tpu_torch.schema.features import SCHEMA

FAMILIES = ("linear", "mlp", "ft_transformer", "moe", "bert")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# Families the exact tier does not serve yet, with what ports them.
_UNPORTED = {
    "ft_transformer": "the FT-Transformer is ROADMAP A1c",
    "bert": "the single-record BertEncoder is ROADMAP A1c (the long-context "
    "doc model, doc_records > 1, is a doc bundle)",
    "moe": "the MoE transformer is ROADMAP A9",
    "gbm": "the sklearn tree-ensemble floor is ROADMAP A8",
    "rf": "the sklearn tree-ensemble floor is ROADMAP A8",
}


def build_model(config: ModelConfig, members: int = 0) -> nn.Module:
    """The exact-tier module of ``config``, on the CPU with zero weights
    (load a bundle's params into it). ``ensemble_size > 1`` wraps the
    family in a ``DeepEnsemble`` whose member carries the member axis."""
    if config.ensemble_size > 1:
        single = dataclasses.replace(config, ensemble_size=1)
        size = config.ensemble_size
        return DeepEnsemble(build_model(single, members=size), size)
    if config.family in _UNPORTED:
        raise ValueError(
            f"model family {config.family!r} is not ported to the exact tier: "
            f"{_UNPORTED[config.family]}"
        )
    if config.family not in FAMILIES:
        raise ValueError(f"unknown model family {config.family!r}; one of {FAMILIES}")
    if config.precision not in DTYPES:
        raise ValueError(f"unknown precision {config.precision!r}")
    dtype = DTYPES[config.precision]
    if config.family == "linear":
        return LinearModel(SCHEMA.cards, SCHEMA.num_numeric, dtype, members)
    return MLP(
        SCHEMA.cards,
        SCHEMA.num_numeric,
        embed_dim=config.embed_dim,
        hidden_dims=tuple(config.hidden_dims),
        dtype=dtype,
        members=members,
    )
