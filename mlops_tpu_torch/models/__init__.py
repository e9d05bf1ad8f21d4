"""Model zoo (ported: every family of the JAX package's zoo, the
exact tier's linear, mlp, FT-Transformer, mixture-of-experts and
single-record BERT and deep ensembles of any of them, the BERT
masked-LM of pretraining, the long-context document BERT, and the
sklearn tree-ensemble floor in ``models/gbm.py``).

``build_model`` is the JAX package's (``mlops_tpu/models/__init__.py``);
the sklearn families are refused with the JAX package's message (they
have no module). Every model maps ``(cat_ids int32 [N, C], numeric f32
[N, M], train=False, generator=None) -> logits f32 [N]`` (a deep
ensemble in training: ``[K, N]``); ``generator`` is the trainer's
dropout stream, None in eval. A family with auxiliary losses (``moe``)
returns ``(logits, aux [(K,) blocks])`` in training instead
(``train/loop.py::training_loss`` adds them). ``init_params`` starts a
model from flax's default initializers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.models.bert import BertEncoder
from mlops_tpu_torch.models.ensemble import DeepEnsemble
from mlops_tpu_torch.models.ft_transformer import FTTransformer
from mlops_tpu_torch.models.gbm import SKLEARN_FAMILIES
from mlops_tpu_torch.models.layers import Dense, Embed, LayerNorm
from mlops_tpu_torch.models.mlp import MLP, LinearModel
from mlops_tpu_torch.models.moe import MoETransformer
from mlops_tpu_torch.schema.features import SCHEMA

FAMILIES = ("linear", "mlp", "ft_transformer", "moe", "bert")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_model(config: ModelConfig, members: int = 0) -> nn.Module:
    """The exact-tier module of ``config``, on the CPU with zero weights
    (load a bundle's params or ``init_params`` into it). ``ensemble_size
    > 1`` wraps the family in a ``DeepEnsemble`` whose member carries the
    member axis."""
    if config.ensemble_size > 1:
        single = dataclasses.replace(config, ensemble_size=1)
        size = config.ensemble_size
        return DeepEnsemble(build_model(single, members=size), size)
    if config.family in SKLEARN_FAMILIES:
        raise ValueError(
            f"family {config.family!r} is the CPU sklearn baseline (BASELINE "
            "config 1) — it has no Flax module; train it via `run_training` / "
            "the `train` CLI, which packages it as a sklearn-flavor bundle"
        )
    if config.family not in FAMILIES:
        raise ValueError(f"unknown model family {config.family!r}; one of {FAMILIES}")
    if config.precision not in DTYPES:
        raise ValueError(f"unknown precision {config.precision!r}")
    dtype = DTYPES[config.precision]
    if config.family == "linear":
        return LinearModel(SCHEMA.cards, SCHEMA.num_numeric, dtype, members)
    if config.family == "ft_transformer":
        return FTTransformer(
            SCHEMA.cards,
            SCHEMA.num_numeric,
            token_dim=config.token_dim,
            depth=config.depth,
            heads=config.heads,
            dropout=config.dropout,
            dtype=dtype,
            members=members,
        )
    if config.family == "moe":
        return MoETransformer(
            SCHEMA.cards,
            SCHEMA.num_numeric,
            token_dim=config.token_dim,
            depth=config.depth,
            heads=config.heads,
            num_experts=config.num_experts,
            dropout=config.dropout,
            dtype=dtype,
            members=members,
        )
    if config.family == "bert":
        return BertEncoder(
            SCHEMA.cards,
            SCHEMA.num_numeric,
            hidden=config.token_dim,
            depth=config.depth,
            heads=config.heads,
            dropout=config.dropout,
            dtype=dtype,
            members=members,
        )
    return MLP(
        SCHEMA.cards,
        SCHEMA.num_numeric,
        embed_dim=config.embed_dim,
        hidden_dims=tuple(config.hidden_dims),
        dtype=dtype,
        members=members,
        dropout=config.dropout,
    )


# flax's truncated_normal(-2, 2) has standard deviation 0.8796...; its
# variance_scaling divides the scale by this so the kept values have
# variance scale / fan_in.
_TRUNC_STD = 0.87962566103423978

# Parameters that are not a layer's, by name, with the standard deviation
# of their flax initializer (0: zeros): the BERT models' ``pos_embed``,
# the FT-Transformer tokenizer's ``num_weight``, ``cls`` and ``num_bias``,
# the MoE's stacked experts and their biases.
_RAW_PARAM_STD = {
    "pos_embed": 0.02, "num_weight": 0.02, "cls": 0.02, "num_bias": 0.0,
    "experts_in": 0.02, "experts_out": 0.02,
    "experts_in_bias": 0.0, "experts_out_bias": 0.0,
}


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """``model`` with seeded weights (numpy's generator) from flax's
    default initializers, as the JAX package's ``init_params`` starts a
    model: Dense/DenseGeneral kernels ``lecun_normal`` (a normal truncated
    at +-2 of its scale, rescaled so its variance is 1/fan_in, fan_in the
    contracted features), embedding rows N(0, 1/features), biases 0,
    LayerNorm scales 1, and the named raw parameters of
    ``_RAW_PARAM_STD``. A member axis (``members=K``) draws every member
    independently, as flax's ``nn.vmap`` with ``split_rngs={"params":
    True}`` does. The bits differ from jax.random's; the distributions do
    not."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    def lecun_normal(shape, fan_in):
        x = rng.standard_normal(shape)
        out = np.abs(x) > 2.0
        while out.any():  # redraw what falls outside [-2, 2]
            x[out] = rng.standard_normal(int(out.sum()))
            out = np.abs(x) > 2.0
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        return torch.from_numpy((x * std).astype(np.float32))

    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.kernel.copy_(lecun_normal(mod.kernel.shape, mod.in_features))
            mod.bias.zero_()
        elif isinstance(mod, Embed):
            shape = mod.embedding.shape
            mod.embedding.copy_(normal(shape, 1.0 / math.sqrt(shape[-1])))
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        std = _RAW_PARAM_STD.get(name.rsplit(".", 1)[-1])
        if std is not None:
            p.copy_(normal(p.shape, std) if std else torch.zeros_like(p))
    return model


__all__ = [
    "DTYPES",
    "FAMILIES",
    "BertEncoder",
    "DeepEnsemble",
    "FTTransformer",
    "LinearModel",
    "MLP",
    "MoETransformer",
    "build_model",
    "init_params",
]
