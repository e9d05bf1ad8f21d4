"""Pipeline-parallel training: GPipe over transformer trunks (the JAX
package's ``train/pipeline_parallel.py``).

``model.pipeline_stages=S`` on a family whose trunk is a run of identical
``TransformerBlock``s (bert, ft_transformer) splits the ``depth`` blocks
into S stages over the mesh's 'stage' axis and streams
``train.pipeline_microbatches`` microbatches through the ring of
``parallel/pipeline.py``. On a ``('data', 'stage')`` mesh each data index
runs its own ring on its rows of every microbatch.

The stage layout is the JAX package's: ``{"embed": ..., "stages": ...,
"head": ...}``, the dense tree's ``block_i`` subtrees stacked ``[S, L,
...]`` (L = depth / S layers per stage), flattened here into the
``PipelineModel``'s names ``embed.*``, ``stages.*`` and ``head.*``; each
rank holds its ``[1, L, ...]`` block of ``stages.*`` and the whole embed
front and read-out. ``merge_trunk_params`` turns the stages back into
the dense tree, so a pipeline-trained model packages and serves as its
family does: the pipeline is a training-time layout, not another model.
The optimizer is the dense trainer's (global-norm clip, warmup-cosine
AdamW), its norm completed over the stages. GPipe sums a stage's
gradients over the microbatches, in another order than the dense step's
one product, so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mlops_tpu_torch.config import ModelConfig, TrainConfig
from mlops_tpu_torch.models import DTYPES, build_model, init_params
from mlops_tpu_torch.models.bert import TokenLayout, apply_cls_head, apply_embed_front, tokenize
from mlops_tpu_torch.models.ft_transformer import (
    FeatureTokenizer,
    TransformerBlock,
    apply_ft_head,
)
from mlops_tpu_torch.models.layers import Dense, Embed, LayerNorm
from mlops_tpu_torch.parallel.mesh import Mesh
from mlops_tpu_torch.parallel.pipeline import make_pipeline
from mlops_tpu_torch.parallel.sharding import shard_tensor
from mlops_tpu_torch.parallel.steps import ShardedTrainStep
from mlops_tpu_torch.schema.features import SCHEMA


class BertPPEmbed(nn.Module):
    """The dense ``BertEncoder``'s embedding front as its own module, under
    the dense names (``tok_embed``, ``pos_embed``, ``ln_embed``)."""

    def __init__(self, cards, num_numeric: int, hidden: int, num_bins: int = 32,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.layout = TokenLayout(tuple(cards), num_numeric, num_bins)
        self.dtype = dtype
        self.tok_embed = Embed(self.layout.vocab_size, hidden, dtype)
        self.pos_embed = nn.Parameter(torch.zeros((self.layout.seq_len, hidden)))
        self.ln_embed = LayerNorm(hidden, dtype)

    def forward(self, cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
        return apply_embed_front(self, tokenize(cat_ids, numeric, self.layout))


class BertPPHead(nn.Module):
    """The dense ``BertEncoder``'s read-out (``ln_final``, ``pooler``,
    ``head``)."""

    def __init__(self, hidden: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.ln_final = LayerNorm(hidden, dtype)
        self.pooler = Dense((hidden, hidden), (hidden,), dtype)
        self.head = Dense((hidden, 1), (1,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_cls_head(self, x)


class FTPPEmbed(nn.Module):
    """The dense ``FTTransformer``'s feature tokenizer as the front, under
    its dense name ``FeatureTokenizer_0``."""

    def __init__(self, cards, num_numeric: int, token_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.FeatureTokenizer_0 = FeatureTokenizer(cards, num_numeric, token_dim, dtype)

    def forward(self, cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
        return self.FeatureTokenizer_0(cat_ids, numeric)


class FTPPHead(nn.Module):
    """The dense ``FTTransformer``'s read-out (``ln_final``, ``head``)."""

    def __init__(self, token_dim: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.ln_final = LayerNorm(token_dim, dtype)
        self.head = Dense((token_dim, 1), (1,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_ft_head(self, x)


# Per family: the dense tree's top-level names of the (replicated)
# embedding front and read-out; every block_i between them stage-stacks.
_FAMILY_SPLITS = {
    "bert": (("tok_embed", "pos_embed", "ln_embed"), ("ln_final", "pooler", "head")),
    "ft_transformer": (("FeatureTokenizer_0",), ("ln_final", "head")),
}


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def split_trunk_params(dense: dict[str, Any], stages: int, family: str = "bert") -> dict:
    """Dense params (by ``state_dict`` name) -> the stage layout
    ``{"embed": {...}, "stages": {block name: [S, L, ...]}, "head": {...}}``."""
    embed_keys, head_keys = _FAMILY_SPLITS[family]
    depth = len({_top(n) for n in dense if n.startswith("block_")})
    if depth == 0 or depth % stages:
        raise ValueError(f"depth {depth} not divisible into {stages} stages")
    layers = depth // stages
    inner = sorted(n.split(".", 1)[1] for n in dense if n.startswith("block_0."))
    return {
        "embed": {n: v for n, v in dense.items() if _top(n) in embed_keys},
        "stages": {
            leaf: torch.stack([
                torch.stack([
                    torch.as_tensor(dense[f"block_{s * layers + j}.{leaf}"])
                    for j in range(layers)
                ])
                for s in range(stages)
            ])
            for leaf in inner
        },
        "head": {n: v for n, v in dense.items() if _top(n) in head_keys},
    }


def merge_trunk_params(pp: dict) -> dict[str, torch.Tensor]:
    """Inverse of ``split_trunk_params``: the dense params, by name."""
    first = next(iter(pp["stages"].values()))
    stages, layers = first.shape[0], first.shape[1]
    dense = {**pp["embed"], **pp["head"]}
    for i in range(stages * layers):
        for leaf, v in pp["stages"].items():
            dense[f"block_{i}.{leaf}"] = v[i // layers, i % layers]
    return dense


def pp_tree(flat: dict[str, torch.Tensor]) -> dict:
    """``PipelineModel`` names (``embed.*``, ``stages.*``, ``head.*``) ->
    the stage layout's three groups."""
    out: dict = {"embed": {}, "stages": {}, "head": {}}
    for name, v in flat.items():
        group, rest = name.split(".", 1)
        out[group][rest] = v
    return out


class PipelineModel(nn.Module):
    """One rank's part of the stage layout: the whole embed front and
    read-out, and ``stages``, a ``TransformerBlock`` whose every parameter
    holds this rank's ``[1, L, ...]`` block of the stacked ``[S, L, ...]``
    one. ``forward(cat, num)`` takes this rank's rows, microbatch-major
    (``M`` microbatches of equal size), and returns their logits."""

    def __init__(self, config: ModelConfig, mesh: Mesh, microbatches: int,
                 remat: bool = False) -> None:
        super().__init__()
        stages = mesh.size("stage")
        layers = config.depth // stages
        dtype = DTYPES[config.precision]
        if config.family == "bert":
            self.embed = BertPPEmbed(SCHEMA.cards, SCHEMA.num_numeric, config.token_dim,
                                     dtype=dtype)
            self.head = BertPPHead(config.token_dim, dtype)
        else:
            self.embed = FTPPEmbed(SCHEMA.cards, SCHEMA.num_numeric, config.token_dim, dtype)
            self.head = FTPPHead(config.token_dim, dtype)
        self.stages = TransformerBlock(config.heads, config.token_dim, dtype)
        with torch.no_grad():
            for _, p in self.stages.named_parameters():
                p.data = p.data.expand(1, layers, *p.shape).clone()
        # The block the stacked weights are applied through; not a
        # submodule, so its own (zero) parameters are never trained.
        self._block = (TransformerBlock(config.heads, config.token_dim, dtype),)
        self.layers = layers
        self.microbatches = microbatches

        def stage_fn(w: dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
            # w: this stage's [L, ...] leaves, its layers applied in order.
            block = self._block[0]
            for j in range(layers):
                h = functional_call(block, {k: v[j] for k, v in w.items()}, (h,))
            return h

        if remat:
            # Recompute each stage's internal activations on backward from
            # its boundary input (which the pipeline keeps either way).
            plain = stage_fn

            def stage_fn(w, h):  # noqa: F811 - the rematerialized stage
                return checkpoint(plain, w, h, use_reentrant=False)

        self.pipeline = make_pipeline(mesh, stage_fn)

    def forward(self, cat_ids, numeric, train: bool = False, generator=None):
        x = self.embed(cat_ids, numeric)  # [n, S_tok, H]
        n = x.shape[0]
        xm = x.reshape(self.microbatches, n // self.microbatches, *x.shape[1:])
        weights = dict(self.stages.named_parameters())
        y = self.pipeline(weights, xm).reshape(n, *x.shape[1:])
        return self.head(y)


class PPTrainStep(ShardedTrainStep):
    """The GPipe step of this rank: ``step`` takes the global batch; this
    rank runs its rows of every microbatch (microbatch m is global rows
    ``[m*B, (m+1)*B)``, the data index d its ``[d*b, (d+1)*b)`` of each)."""

    @property
    def microbatches(self) -> int:
        return self.model.microbatches

    def local_rows(self, n: int) -> torch.Tensor:
        m = self.microbatches
        dp, di = self.mesh.size("data"), self.mesh.index("data")
        micro = n // m
        b = micro // dp
        starts = torch.arange(m) * micro + di * b
        return (starts[:, None] + torch.arange(b)[None]).reshape(-1).to(self.device)

    def pp_params(self, tensors: dict[str, torch.Tensor] | None = None) -> dict:
        """The whole stage layout (every rank) of this rank's blocks of
        ``tensors`` (the params when None)."""
        return pp_tree(self.gather(tensors if tensors is not None else self.params()))

    def dense_params(self, tensors: dict[str, torch.Tensor] | None = None) -> dict:
        """The dense tree (``merge_trunk_params``) of the whole layout."""
        return merge_trunk_params(self.pp_params(tensors))


def make_pp_train_step(
    model_config: ModelConfig,
    train_config: TrainConfig,
    mesh: Mesh,
    seed: int = 0,
    init_state: dict[str, torch.Tensor] | None = None,
    device: str | torch.device = "cpu",
) -> PPTrainStep:
    """The (DP x) PP train step of a TransformerBlock-trunk family over
    ``mesh`` (a 'stage' axis, and 'data' when present), on ``device``.
    The params start from the dense init of ``seed`` (or ``init_state``,
    whole dense params by name: a pretrained graft), split into the stage
    layout; the forward equals the dense model's."""
    if model_config.family not in _FAMILY_SPLITS:
        raise ValueError(
            "pipeline_stages applies to the TransformerBlock-trunk "
            f"families {tuple(_FAMILY_SPLITS)}, not {model_config.family!r}"
        )
    if model_config.ensemble_size > 1:
        raise ValueError(
            "pipeline_stages does not compose with ensemble_size>1: the "
            "pipeline splits a single trunk's blocks across stages; train "
            "the ensemble dense or set ensemble_size=1"
        )
    if "stage" not in mesh.axis_names:
        raise ValueError(
            "model.pipeline_stages needs a mesh with a 'stage' axis "
            "(parallel.make_nd_mesh({'data': d, 'stage': s}))"
        )
    stages = mesh.shape["stage"]
    if model_config.pipeline_stages and model_config.pipeline_stages != stages:
        raise ValueError(
            f"config pipeline_stages={model_config.pipeline_stages} != "
            f"mesh 'stage' axis {stages}"
        )
    if model_config.depth % stages:
        raise ValueError(
            f"model.depth={model_config.depth} must divide into {stages} stages"
        )
    if model_config.dropout:
        raise ValueError(
            "the pipeline path needs model.dropout=0 (stage_fn runs inside "
            "shard_map without an rng stream; long_context.py makes the "
            "same trade for the ring)"
        )
    micro = train_config.pipeline_microbatches
    dp = mesh.shape.get("data", 1)
    if train_config.batch_size % micro or (train_config.batch_size // micro) % dp:
        raise ValueError(
            f"batch_size={train_config.batch_size} must split into "
            f"{micro} microbatches x 'data' axis {dp}"
        )
    dense_cfg = dataclasses.replace(model_config, pipeline_stages=0)
    if init_state is None:
        init_state = dict(init_params(build_model(dense_cfg), seed).state_dict())
    layout = split_trunk_params(init_state, stages, model_config.family)
    model = PipelineModel(model_config, mesh, micro, train_config.pipeline_remat)
    specs = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            group, rest = name.split(".", 1)
            whole = torch.as_tensor(layout[group][rest]).float()
            spec = ("stage",) + (None,) * (whole.dim() - 1) if group == "stages" else ()
            specs[name] = spec
            p.copy_(shard_tensor(whole, spec, mesh))
    model.to(device)
    return PPTrainStep(model, train_config, mesh, specs, split_axis="stage")
