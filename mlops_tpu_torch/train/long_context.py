"""Long-context documents: grouping rows into record histories, the
dense doc model, and its train step on one card (the JAX package's
``train/long_context.py`` without a mesh; the sequence-parallel ring is
not ported)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mlops_tpu_torch.config import ModelConfig, TrainConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.models import DTYPES, init_params
from mlops_tpu_torch.models.bert import BertDocEncoder
from mlops_tpu_torch.ops.attention import check_flash_head_dim
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.loop import sigmoid_bce, update_ema


def group_documents(
    cat_ids: np.ndarray, numeric: np.ndarray, doc_records: int
) -> tuple[np.ndarray, np.ndarray]:
    """Group consecutive encoded rows into record histories:
    ``[N,C]`` -> ``[D,R,C]``. Rows past the last full document drop."""
    docs = cat_ids.shape[0] // doc_records
    take = docs * doc_records
    cat = cat_ids[:take].reshape(docs, doc_records, -1)
    num = numeric[:take].reshape(docs, doc_records, -1)
    return cat, num


def make_documents(
    ds: EncodedDataset, doc_records: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``group_documents`` plus labels: a document's label is its LAST
    record's (predict the next default from the history), f32."""
    if ds.labels is None:
        raise ValueError("document training needs labels")
    cat, num = group_documents(ds.cat_ids, ds.numeric, doc_records)
    docs = cat.shape[0]
    labels = ds.labels[: docs * doc_records].reshape(docs, doc_records)[:, -1]
    return cat, num, labels.astype(np.float32)


def check_doc_attention(config: ModelConfig, device: str | torch.device) -> None:
    """Refuse a doc model whose attention would reach the flash kernels
    on ``device`` at a head_dim they are not compiled for (ROADMAP C1),
    before any forward."""
    seq = 2 + 2 * (len(SCHEMA.cards) + SCHEMA.num_numeric) * config.doc_records
    check_flash_head_dim(config.token_dim // config.heads, seq, device)


def build_doc_model(
    config: ModelConfig, device: str | torch.device | None = None
) -> BertDocEncoder:
    """The dense ``BertDocEncoder`` of ``config``, on the CPU with zero
    weights (load a bundle's params or ``models.init_params`` into it).
    Dropout is 0, as in the JAX package's ``build_doc_model``;
    ``seq_parallel=true`` (the ring) is refused: it is not ported. With
    ``device``, the device the model will run on, a head_dim that has no
    flash kernel there is refused too (``check_doc_attention``)."""
    if device is not None:
        check_doc_attention(config, device)
    if config.seq_parallel:
        raise ValueError(
            "model.seq_parallel=true (ring attention over a 'seq' mesh axis) "
            "is not ported; the port builds the dense doc model only"
        )
    if config.precision not in DTYPES:
        raise ValueError(f"unknown precision {config.precision!r}")
    return BertDocEncoder(
        cards=SCHEMA.cards,
        num_numeric=SCHEMA.num_numeric,
        doc_records=config.doc_records,
        hidden=config.token_dim,
        depth=config.depth,
        heads=config.heads,
        dtype=DTYPES[config.precision],
    )


@dataclasses.dataclass
class DocTrainStep:
    """The doc model with its optimizer and (``train.ema_decay > 0``) its
    zero-initialized EMA accumulator, on one device. ``step`` is one
    training step: the JAX ``step_fn`` with the state held here."""

    model: BertDocEncoder
    optimizer: torch.optim.Optimizer
    ema: dict[str, torch.Tensor] | None
    decay: float
    pos_weight: float

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def step(self, cat: torch.Tensor, num: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        """Loss, gradients, one AdamW update and the EMA update; returns
        the step's loss (detached, on the model's device)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = sigmoid_bce(self.model(cat, num), lab, self.pos_weight)
        loss.backward()
        self.optimizer.step()
        if self.decay:
            update_ema(self.ema, self.params(), self.decay)
        return loss.detach()


def make_doc_train_step(
    model_config: ModelConfig,
    train_config: TrainConfig,
    mesh: object | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> DocTrainStep:
    """The dense doc model, freshly initialized from ``seed`` with flax's
    initializers, on ``device`` (``train.device`` when None: the card
    unless "cpu"), with ``torch.optim.AdamW`` at a constant learning
    rate: betas (0.9, 0.999), eps 1e-8 and ``train.weight_decay`` on every
    parameter, the arithmetic of ``optax.adamw``'s defaults (decay on the
    old parameters, bias correction folded into the step). A mesh (the
    JAX package's DP x SP layout) is refused: one card only."""
    if mesh is not None:
        raise ValueError(
            "a device mesh (DP x SP document training) is not ported: the "
            "port trains the dense doc model on one card"
        )
    dev = resolve_device(device if device is not None else train_config.device)
    model = init_params(build_doc_model(model_config, dev), seed).to(dev).train()
    optimizer = torch.optim.AdamW(
        model.parameters(),
        lr=train_config.learning_rate,
        betas=(0.9, 0.999),
        eps=1e-8,
        weight_decay=train_config.weight_decay,
    )
    decay = train_config.ema_decay
    ema = (
        {k: torch.zeros_like(p) for k, p in model.named_parameters()}
        if decay else None
    )
    return DocTrainStep(
        model=model, optimizer=optimizer, ema=ema, decay=decay,
        pos_weight=train_config.pos_weight,
    )
