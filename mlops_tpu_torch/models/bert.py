"""The long-context document BERT of the JAX package's ``models/bert.py``.

Records render as tokens with pure integer arithmetic (``tokenize``):
``[CLS] name_1 value_1 ... name_23 value_23 [SEP]``, categoricals as
per-feature vocabulary offsets, standardized numerics as per-feature
bins of fixed standard-normal quantile edges. ``BertDocEncoder`` reads
``doc_records`` consecutive records as one document of ``2 + 46R``
tokens (R = 11: 508) and scores the last record's default from the whole
history. Module and parameter names follow the flax tree (``tok_embed``,
``pos_embed``, ``ln_embed``, ``block_i``, ``ln_final``, ``pooler``,
``head``). With dropout 0 the training path is the eval path under
autograd; the single-record ``BertEncoder`` and the masked-LM head are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Sequence

import numpy as np
import torch
from torch import nn

from mlops_tpu_torch.models.ft_transformer import TransformerBlock
from mlops_tpu_torch.models.layers import Dense, Embed, LayerNorm

PAD_ID, CLS_ID, SEP_ID, MASK_ID = 0, 1, 2, 3
_SPECIAL = 4


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Static vocabulary layout derived from the feature schema.

    Token id space: ``[PAD][CLS][SEP][MASK]`` | one name token per feature |
    per-categorical-feature value blocks (card each, OOV included) |
    per-numeric-feature bin blocks (num_bins each).
    """

    cards: tuple[int, ...]
    num_numeric: int
    num_bins: int

    @property
    def num_features(self) -> int:
        return len(self.cards) + self.num_numeric

    @property
    def name_offset(self) -> int:
        return _SPECIAL

    @property
    def cat_offsets(self) -> tuple[int, ...]:
        base = _SPECIAL + self.num_features
        offsets = []
        for card in self.cards:
            offsets.append(base)
            base += card
        return tuple(offsets)

    @property
    def bin_offsets(self) -> tuple[int, ...]:
        base = _SPECIAL + self.num_features + sum(self.cards)
        return tuple(base + j * self.num_bins for j in range(self.num_numeric))

    @property
    def vocab_size(self) -> int:
        return (
            _SPECIAL
            + self.num_features
            + sum(self.cards)
            + self.num_numeric * self.num_bins
        )

    @property
    def seq_len(self) -> int:
        # [CLS] + (name, value) per feature + [SEP]
        return 2 + 2 * self.num_features

    def bin_edges(self) -> np.ndarray:
        """Interior standard-normal quantile edges (num_bins - 1 of them),
        f32: numerics arrive standardized, so fixed N(0,1) quantiles give
        near-uniform bins without data-dependent state in the model."""
        nd = NormalDist()
        qs = [i / self.num_bins for i in range(1, self.num_bins)]
        return np.asarray([nd.inv_cdf(q) for q in qs], np.float32)


def tokenize(
    cat_ids: torch.Tensor, numeric: torch.Tensor, layout: TokenLayout
) -> torch.Tensor:
    """Render records as token ids: ``(int[N,C], f32[N,M]) -> int64[N,S]``.
    Numerics land in bins by ``searchsorted(edges, x, side="right")``."""
    n = cat_ids.shape[0]
    f = layout.num_features
    dev = cat_ids.device
    names = torch.arange(layout.name_offset, layout.name_offset + f, device=dev)
    cat_tok = torch.tensor(layout.cat_offsets, device=dev)[None] + cat_ids.long()
    edges = torch.from_numpy(layout.bin_edges()).to(dev)
    bins = torch.searchsorted(edges, numeric.float().contiguous(), right=True)
    num_tok = torch.tensor(layout.bin_offsets, device=dev)[None] + bins
    values = torch.cat([cat_tok, num_tok], dim=1)  # [N, F]
    pairs = torch.stack([names[None].expand(n, f), values], dim=2).reshape(n, 2 * f)
    cls = torch.full((n, 1), CLS_ID, dtype=torch.long, device=dev)
    sep = torch.full((n, 1), SEP_ID, dtype=torch.long, device=dev)
    return torch.cat([cls, pairs, sep], dim=1)


def tokenize_documents(
    cat_ids: torch.Tensor, numeric: torch.Tensor, layout: TokenLayout
) -> torch.Tensor:
    """Render record histories as one sequence each:
    ``(int[N,R,C], f32[N,R,M]) -> int64[N, 2 + 2*F*R]``, laid out as
    ``[CLS] rec_1 pairs ... rec_R pairs [SEP]``."""
    n, r, c = cat_ids.shape
    flat = tokenize(
        cat_ids.reshape(n * r, c), numeric.reshape(n * r, -1), layout
    )  # [N*R, 2 + 2F]
    pairs = flat[:, 1:-1].reshape(n, r * 2 * layout.num_features)
    dev = cat_ids.device
    cls = torch.full((n, 1), CLS_ID, dtype=torch.long, device=dev)
    sep = torch.full((n, 1), SEP_ID, dtype=torch.long, device=dev)
    return torch.cat([cls, pairs, sep], dim=1)


def apply_embed_front(mod: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """The shared embedding front: ``ln_embed(tok_embed + pos_embed)``,
    the sum in the model's type."""
    x = mod.tok_embed(tokens) + mod.pos_embed.to(mod.dtype)[None]
    return mod.ln_embed(x)


def apply_cls_head(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The shared read-out: ``ln_final`` on [CLS], a tanh pooler, the head
    logit. The logit is rounded to the model's type before the cast to
    f32, as in the JAX package (about 0.008 at logits near 1 in bf16)."""
    cls = mod.ln_final(x[:, 0])
    pooled = torch.tanh(mod.pooler(cls))
    return mod.head(pooled)[:, 0].float()


class BertDocEncoder(nn.Module):
    """Long-context BERT over record histories (dense attention).

    ``forward(cat[N,R,C], numeric[N,R,M]) -> logits f32[N]``. Attention
    runs through ``ops.attention.attend``: the flash kernel on the card at
    ``2 + 46R >= 128`` tokens (R >= 3), the dense reference below that
    and on the CPU.
    """

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        doc_records: int,
        hidden: int = 256,
        depth: int = 4,
        heads: int = 8,
        num_bins: int = 32,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.layout = TokenLayout(tuple(cards), num_numeric, num_bins)
        self.doc_records = doc_records
        self.depth = depth
        self.dtype = dtype
        self.tok_embed = Embed(self.layout.vocab_size, hidden, dtype)
        self.pos_embed = nn.Parameter(torch.zeros((self.doc_seq_len, hidden)))
        self.ln_embed = LayerNorm(hidden, dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(heads, hidden, dtype))
        self.ln_final = LayerNorm(hidden, dtype)
        self.pooler = Dense((hidden, hidden), (hidden,), dtype)
        self.head = Dense((hidden, 1), (1,), dtype)

    @property
    def doc_seq_len(self) -> int:
        return 2 + 2 * self.layout.num_features * self.doc_records

    def forward(self, cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
        tokens = tokenize_documents(cat_ids, numeric, self.layout)  # [N, S]
        x = apply_embed_front(self, tokens)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return apply_cls_head(self, x)


# flax's truncated_normal(-2, 2) has standard deviation 0.8796...; its
# variance_scaling divides the scale by this so the kept values have
# variance scale / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_doc_params(model: BertDocEncoder, seed: int) -> BertDocEncoder:
    """Seeded weights (numpy's generator) from flax's default
    initializers, as a fresh flax model starts: Dense/DenseGeneral
    kernels ``lecun_normal`` (a normal truncated at +-2 of its scale,
    rescaled so its variance is 1/fan_in, fan_in the contracted
    features), embedding rows N(0, 1/features), ``pos_embed`` N(0, 0.02^2),
    biases 0, LayerNorm scales 1. The numbers differ from flax's (another
    generator); their distributions do not."""
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
            mod.embedding.copy_(normal(shape, 1.0 / math.sqrt(shape[1])))
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
    model.pos_embed.copy_(normal(model.pos_embed.shape, 0.02))
    return model
