"""Long-context documents: grouping rows into record histories, the doc
model and its train step (the JAX package's ``train/long_context.py``).

Without a mesh the step is the dense model's on one device. On a
``('data', 'seq')`` mesh (``model.seq_parallel=true``) the batch splits
over 'data' and each document's tokens over 'seq': every rank runs its
token block through the trunk, attention is the ring
(``parallel/ring_attention.py``), and [CLS] is gathered for the
read-out. The trunk's gradients (embeddings and blocks: each rank's
share comes from its tokens) are summed over 'seq', the read-out's
(computed alike on every rank of the axis) are kept, and all are meaned
over 'data'; the params stay whole and alike on every rank."""

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
from mlops_tpu_torch.parallel.collectives import all_reduce_sum, gather
from mlops_tpu_torch.parallel.ring_attention import make_ring_attention
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.loop import eval_logits, sigmoid_bce, update_ema

# The doc model's read-out: computed alike on every rank of the 'seq'
# axis from the gathered [CLS], so its gradients are not summed there.
READOUT = ("ln_final", "pooler", "head")


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
    config: ModelConfig, device: str | torch.device | None = None, mesh=None
) -> BertDocEncoder:
    """The ``BertDocEncoder`` of ``config``, on the CPU with zero weights
    (load a bundle's params or ``models.init_params`` into it). Dropout
    is 0, as in the JAX package's ``build_doc_model``. ``seq_parallel=
    true`` needs a mesh with a 'seq' axis and lays the model out over it
    (the ring); otherwise attention is the dense dispatcher. With
    ``device``, the device the model will run on, a head_dim that has no
    flash kernel there is refused (``check_doc_attention``)."""
    if device is not None:
        check_doc_attention(config, device)
    if config.seq_parallel and (mesh is None or "seq" not in mesh.axis_names):
        raise ValueError(
            "model.seq_parallel=true needs a mesh with a 'seq' axis "
            "(parallel.make_nd_mesh({'data': d, 'seq': s}))"
        )
    if config.precision not in DTYPES:
        raise ValueError(f"unknown precision {config.precision!r}")
    model = BertDocEncoder(
        cards=SCHEMA.cards,
        num_numeric=SCHEMA.num_numeric,
        doc_records=config.doc_records,
        hidden=config.token_dim,
        depth=config.depth,
        heads=config.heads,
        dtype=DTYPES[config.precision],
    )
    if config.seq_parallel:
        model.shard_sequence(mesh, "seq", make_ring_attention(mesh, "seq"))
    return model


@dataclasses.dataclass
class DocTrainStep:
    """The doc model with its optimizer and (``train.ema_decay > 0``) its
    zero-initialized EMA accumulator, on this rank's device (with
    ``mesh``, one rank of the DP x SP layout). ``step`` is one training
    step: the JAX ``step_fn`` with the state held here."""

    model: BertDocEncoder
    optimizer: torch.optim.Optimizer
    ema: dict[str, torch.Tensor] | None
    decay: float
    pos_weight: float
    mesh: object | None = None  # the ('data', 'seq') mesh, or None

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _rows(self, n: int) -> slice:
        if self.mesh is None:
            return slice(0, n)
        dp, di = self.mesh.size("data"), self.mesh.index("data")
        b = n // dp
        return slice(di * b, (di + 1) * b)

    def _data_mean(self, x: torch.Tensor) -> torch.Tensor:
        group = self.mesh.groups.get("data")
        return x if group is None else all_reduce_sum(x, group) / self.mesh.size("data")

    @torch.no_grad()
    def _sync_grads(self) -> None:
        seq = self.mesh.groups.get("seq")
        for name, p in self.model.named_parameters():
            if seq is not None and name.split(".", 1)[0] not in READOUT:
                p.grad.copy_(all_reduce_sum(p.grad, seq))
            p.grad.copy_(self._data_mean(p.grad))

    def step(self, cat: torch.Tensor, num: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        """Loss, gradients, one AdamW update and the EMA update on the
        global batch (on a mesh this rank takes its rows over 'data');
        returns the batch's loss (detached, on the model's device)."""
        rows = self._rows(cat.shape[0])
        self.optimizer.zero_grad(set_to_none=True)
        loss = sigmoid_bce(self.model(cat[rows], num[rows]), lab[rows], self.pos_weight)
        loss.backward()
        if self.mesh is not None:
            self._sync_grads()
            loss = self._data_mean(loss.detach())
        self.optimizer.step()
        if self.decay:
            update_ema(self.ema, self.params(), self.decay)
        return loss.detach()

    def eval_logits(
        self, params: dict[str, torch.Tensor], cat: torch.Tensor, num: torch.Tensor,
        chunk: int,
    ) -> torch.Tensor:
        """Logits of ``params`` over whole documents; on a mesh the
        documents are padded to a multiple of the 'data' axis, each data
        index scores its block through the ring, and the blocks are
        gathered."""
        if self.mesh is None:
            return eval_logits(self.model, params, cat, num, chunk)
        n = cat.shape[0]
        dp = self.mesh.size("data")
        pad = (-n) % dp
        if pad:
            cat = torch.cat([cat, cat.new_zeros((pad, *cat.shape[1:]))])
            num = torch.cat([num, num.new_zeros((pad, *num.shape[1:]))])
        rows = self._rows(n + pad)
        local = eval_logits(self.model, params, cat[rows], num[rows], chunk)
        group = self.mesh.groups.get("data")
        return (local if group is None else gather(local, 0, group))[:n]


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
    old parameters, bias correction folded into the step). With a mesh
    (the DP x SP layout) the batch splits over its 'data' axis and, with
    ``seq_parallel``, each document's tokens over 'seq'."""
    dev = resolve_device(device if device is not None else train_config.device)
    model = init_params(build_doc_model(model_config, dev, mesh), seed).to(dev).train()
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
        pos_weight=train_config.pos_weight, mesh=mesh,
    )
