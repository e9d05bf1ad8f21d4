"""The BERT models of the JAX package's ``models/bert.py``: the
single-record ``BertEncoder`` (48 tokens, the exact tier's ``bert``
family), its masked-feature pretraining twin ``BertMaskedLM`` and the
long-context document ``BertDocEncoder``.

Records render as tokens with pure integer arithmetic (``tokenize``):
``[CLS] name_1 value_1 ... name_23 value_23 [SEP]``, categoricals as
per-feature vocabulary offsets, standardized numerics as per-feature
bins of fixed standard-normal quantile edges. ``BertDocEncoder`` reads
``doc_records`` consecutive records as one document of ``2 + 46R``
tokens (R = 11: 508) and scores the last record's default from the whole
history. Module and parameter names follow the flax tree (``tok_embed``,
``pos_embed``, ``ln_embed``, ``block_i``, ``ln_final``, ``pooler``,
``head``). The doc model trains with dropout 0, where the training path
is the eval path under autograd; ``BertEncoder`` takes the zoo's
``train``/``generator`` and drops out after the embedding front and in
its blocks; with ``members=K`` it is the member of a deep ensemble (a
leading ``[K, ...]`` axis on every parameter, logits ``[K, N]``).
``BertMaskedLM`` shares the classifier's trunk names, so
``transfer_encoder_params`` grafts a pretrained trunk into it.
"""

from __future__ import annotations

import dataclasses
import threading
from statistics import NormalDist
from typing import Sequence

import numpy as np
import torch
from torch import nn

from mlops_tpu_torch.models.ft_transformer import TransformerBlock
from mlops_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    dropout,
)
from mlops_tpu_torch.parallel.collectives import gather

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


_LAYOUT_TENSORS: dict[tuple, tuple[torch.Tensor, ...]] = {}
_LAYOUT_LOCK = threading.Lock()


def _layout_tensors(
    layout: TokenLayout, device: torch.device
) -> tuple[torch.Tensor, ...]:
    """The layout's categorical offsets, bin edges and bin offsets on
    ``device``, made once and kept for good: a CUDA graph captured over
    ``tokenize`` reads them where they lie (an upload cannot be
    captured)."""
    key = (layout, device)
    with _LAYOUT_LOCK:
        if key not in _LAYOUT_TENSORS:
            _LAYOUT_TENSORS[key] = (
                torch.tensor(layout.cat_offsets, device=device),
                torch.from_numpy(layout.bin_edges()).to(device),
                torch.tensor(layout.bin_offsets, device=device),
            )
        return _LAYOUT_TENSORS[key]


def tokenize(
    cat_ids: torch.Tensor, numeric: torch.Tensor, layout: TokenLayout
) -> torch.Tensor:
    """Render records as token ids: ``(int[N,C], f32[N,M]) -> int64[N,S]``.
    Numerics land in bins by ``searchsorted(edges, x, side="right")``."""
    n = cat_ids.shape[0]
    f = layout.num_features
    dev = cat_ids.device
    names = torch.arange(layout.name_offset, layout.name_offset + f, device=dev)
    cat_offsets, edges, bin_offsets = _layout_tensors(layout, dev)
    cat_tok = cat_offsets[None] + cat_ids.long()
    bins = torch.searchsorted(edges, numeric.float().contiguous(), right=True)
    num_tok = bin_offsets[None] + bins
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
    the sum in the model's type (``[(K,) N, S, H]``: a member axis leads
    the table, the positions and the result)."""
    pos = mod.pos_embed.to(mod.dtype).unsqueeze(-3)  # [(K,) 1, S, H]
    return mod.ln_embed(mod.tok_embed(tokens) + pos)


def apply_cls_head(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The shared read-out: ``ln_final`` on [CLS], a tanh pooler, the head
    logit. The logit is rounded to the model's type before the cast to
    f32, as in the JAX package (about 0.008 at logits near 1 in bf16)."""
    cls = mod.ln_final(x[..., 0, :])
    pooled = torch.tanh(mod.pooler(cls))
    return mod.head(pooled)[..., 0].float()


class _BertTrunk(nn.Module):
    """The trunk ``BertEncoder`` and ``BertMaskedLM`` share, under the
    flax names: ``tok_embed``, ``pos_embed``, ``ln_embed``, ``block_i``
    and ``ln_final``; ``trunk`` runs the embedding front, its dropout and
    the blocks over token ids."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        hidden: int,
        depth: int,
        heads: int,
        dropout: float,
        num_bins: int,
        dtype: torch.dtype,
        members: int = 0,
    ) -> None:
        super().__init__()
        self.layout = TokenLayout(tuple(cards), num_numeric, num_bins)
        self.depth = depth
        self.dropout = dropout
        self.dtype = dtype
        self.members = members
        lead = (members,) if members else ()
        self.tok_embed = Embed(self.layout.vocab_size, hidden, dtype, members)
        self.pos_embed = nn.Parameter(torch.zeros(lead + (self.layout.seq_len, hidden)))
        self.ln_embed = LayerNorm(hidden, dtype, members=members)
        for i in range(depth):
            self.add_module(
                f"block_{i}", TransformerBlock(heads, hidden, dtype, dropout, members)
            )
        self.ln_final = LayerNorm(hidden, dtype, members=members)

    def trunk(
        self, tokens: torch.Tensor, generator: torch.Generator | None
    ) -> torch.Tensor:
        x = dropout(apply_embed_front(self, tokens), self.dropout, generator, rows=-3)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
        return x


class BertEncoder(_BertTrunk):
    """Pre-LN BERT over the single-record token rendering:
    ``(cat_ids, numeric) -> logits f32 [(K,) N]`` over 48 tokens, the
    classifier reading [CLS] (dense attention: the sequence is far below
    the flash kernels' length)."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        hidden: int = 768,
        depth: int = 12,
        heads: int = 12,
        dropout: float = 0.0,
        num_bins: int = 32,
        dtype: torch.dtype = torch.bfloat16,
        members: int = 0,
    ) -> None:
        super().__init__(
            cards, num_numeric, hidden, depth, heads, dropout, num_bins, dtype, members
        )
        self.pooler = Dense((hidden, hidden), (hidden,), dtype, members=members)
        self.head = Dense((hidden, 1), (1,), dtype, members=members)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        gen = generator if train else None
        x = self.trunk(tokenize(cat_ids, numeric, self.layout), gen)
        return apply_cls_head(self, x)


class BertMaskedLM(_BertTrunk):
    """Masked-feature pretraining head over the classifier's trunk: value
    tokens under ``mask`` become ``[MASK]``, and ``mlm_head`` (a Dense to
    the vocabulary in the model's type, after ``ln_final`` on every
    position) predicts the original ids. ``forward(cat_ids, numeric,
    mask bool [N, S], train=True, generator=None) -> (logits f32 [N, S,
    vocab], targets int64 [N, S])``."""

    def __init__(
        self,
        cards: Sequence[int],
        num_numeric: int,
        hidden: int = 768,
        depth: int = 12,
        heads: int = 12,
        dropout: float = 0.0,
        num_bins: int = 32,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__(
            cards, num_numeric, hidden, depth, heads, dropout, num_bins, dtype
        )
        vocab = self.layout.vocab_size
        self.mlm_head = Dense((hidden, vocab), (vocab,), dtype)

    def value_positions(self) -> np.ndarray:
        """Sequence indices of the value tokens, the maskable positions:
        every second slot after CLS, ``[2, 4, ..., 2F]``."""
        return np.arange(2, 2 * self.layout.num_features + 1, 2)

    def forward(
        self,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        mask: torch.Tensor,
        train: bool = True,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        targets = tokenize(cat_ids, numeric, self.layout)
        tokens = torch.where(mask, torch.full_like(targets, MASK_ID), targets)
        x = self.ln_final(self.trunk(tokens, generator if train else None))
        n, s, h = x.shape
        logits = self.mlm_head(x.reshape(n * s, h)).reshape(n, s, -1)
        return logits.float(), targets


class BertDocEncoder(nn.Module):
    """Long-context BERT over record histories.

    ``forward(cat[N,R,C], numeric[N,R,M]) -> logits f32[N]``. Attention
    runs through ``ops.attention.attend``: the flash kernel on the card at
    ``2 + 46R >= 128`` tokens (R >= 3), the dense reference below that
    and on the CPU. ``shard_sequence`` (the sequence-parallel layout,
    ``train/long_context.py``) makes each rank of a 'seq' axis hold its
    block of the tokens through the trunk, its attention the ring of
    ``parallel/ring_attention.py`` (the ``attend_fn`` seam); the [CLS]
    token, on the axis's first rank, is gathered for the read-out.
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
        self.seq = None  # (mesh, axis) under the sequence-parallel layout

    @property
    def doc_seq_len(self) -> int:
        return 2 + 2 * self.layout.num_features * self.doc_records

    def shard_sequence(self, mesh, axis: str, attend_fn) -> None:
        """Lay the model out over ``mesh[axis]``: token blocks through the
        trunk, ``attend_fn`` (the ring) as every block's attention."""
        if self.doc_seq_len % mesh.size(axis):
            raise ValueError(
                f"sequence {self.doc_seq_len} does not divide over '{axis}' "
                f"axis {mesh.size(axis)}"
            )
        self.seq = (mesh, axis)
        for i in range(self.depth):
            getattr(self, f"block_{i}").MultiHeadSelfAttention_0.attend_fn = attend_fn

    def forward(self, cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
        tokens = tokenize_documents(cat_ids, numeric, self.layout)  # [N, S]
        if self.seq is None:
            x = apply_embed_front(self, tokens)
        else:
            mesh, axis = self.seq
            chunk = tokens.shape[1] // mesh.size(axis)
            lo = mesh.index(axis) * chunk
            pos = self.pos_embed[lo: lo + chunk].to(self.dtype).unsqueeze(-3)
            x = self.ln_embed(self.tok_embed(tokens[:, lo: lo + chunk]) + pos)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        if self.seq is not None:
            mesh, axis = self.seq
            x = gather(x[:, :1], 1, mesh.group(axis))  # [N, n, H]: each block's first
        return apply_cls_head(self, x)


def transfer_encoder_params(
    pretrained: dict[str, torch.Tensor], target: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Graft a pretrained trunk into a classifier's params (both flattened
    by ``.``, the ``state_dict`` names): every top-level subtree the two
    share, ``mlm_head`` aside, comes whole from ``pretrained``; the rest
    (``pooler``, ``head``) keeps ``target``'s values, as the JAX
    package's graft of same-named subtrees does."""
    tops = {name.split(".", 1)[0] for name in target}
    grafted = {
        name.split(".", 1)[0] for name in pretrained
    } & tops - {"mlm_head"}
    merged = {k: v for k, v in target.items() if k.split(".", 1)[0] not in grafted}
    merged.update(
        {k: v for k, v in pretrained.items() if k.split(".", 1)[0] in grafted}
    )
    return merged
