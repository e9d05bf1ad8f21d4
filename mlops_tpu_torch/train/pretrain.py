"""Masked-feature pretraining of the BERT trunk: the JAX package's
``train/pretrain.py`` on one device.

``pretrain_bert`` trains ``models.bert.BertMaskedLM`` on unlabeled rows:
each step gathers a minibatch (``batch_indices``, seeded by (seed,
step)), masks value tokens with ``sample_mask`` (Bernoulli(0.15) over the
23 value positions, one uniformly chosen position forced where a row
drew none), and takes cross-entropy on the masked positions only
(``masked_loss``) under optax's plain ``adamw(lr)``: a constant rate,
betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 on every parameter,
biases and LayerNorm scales included, with no clipping and no warmup
(not the trainer's ``ClippedAdamW``). Dropout draws from the step's
generator, as ``fit``'s does. The masks come from numpy on the host, so
the CPU and the card see the same masks; jax.random's bits are not
reproduced.

``save_pretrained`` writes the MLM params as ``pretrained.msgpack`` in
flax's ``to_bytes`` encoding (``bundle/msgpack.py``), so the file crosses
between the packages both ways; ``load_pretrained_variables`` reads one
(either package's) and grafts its trunk into a classifier's params
(``models.bert.transfer_encoder_params``), which ``run_training`` hands
to ``fit`` as its initial state for ``train.init_params``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from mlops_tpu_torch.bundle import msgpack
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.models import DTYPES, init_params
from mlops_tpu_torch.models.bert import BertMaskedLM, transfer_encoder_params
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.loop import batch_indices, dropout_generator
from mlops_tpu_torch.utils.io import atomic_write
from mlops_tpu_torch.weights import flatten_tree, load_params, unflatten_tree

MASK_FRACTION = 0.15
PRETRAINED_NAME = "pretrained.msgpack"
# optax.adamw's defaults.
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


@dataclasses.dataclass
class PretrainResult:
    params: dict[str, torch.Tensor]  # trunk + mlm head, by name, on the CPU
    losses: list[float]  # the 10-bucket mean masked-token loss curve


def build_mlm(config: ModelConfig) -> BertMaskedLM:
    """The masked-LM of ``config``'s BERT widths, on the CPU with zero
    weights."""
    return BertMaskedLM(
        SCHEMA.cards,
        SCHEMA.num_numeric,
        hidden=config.token_dim,
        depth=config.depth,
        heads=config.heads,
        dropout=config.dropout,
        dtype=DTYPES[config.precision],
    )


def masked_loss(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over the masked positions only."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom


def sample_mask(
    rng: np.random.Generator, batch: int, value_pos: np.ndarray, seq_len: int
) -> np.ndarray:
    """``bool [batch, seq_len]``: Bernoulli(``MASK_FRACTION``) over the
    value positions; a row that drew none gets one uniformly chosen value
    position forced, so every row has at least one masked token."""
    v = len(value_pos)
    draw = rng.random((batch, v)) < MASK_FRACTION
    forced = np.eye(v, dtype=bool)[rng.integers(0, v, batch)]
    draw = np.where(draw.any(axis=1, keepdims=True), draw, forced)
    mask = np.zeros((batch, seq_len), bool)
    mask[:, value_pos] = draw
    return mask


def step_mask(seed: int, step: int, batch: int, model: BertMaskedLM) -> np.ndarray:
    """The mask of one step, seeded by (seed, step) like its batch."""
    rng = np.random.default_rng((seed, step, 2))
    return sample_mask(rng, batch, model.value_positions(), model.layout.seq_len)


def make_adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: constant rate, decay on every
    parameter, no clipping."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY,
    )


def mlm_step(
    model: BertMaskedLM,
    opt: torch.optim.Optimizer,
    cat: torch.Tensor,
    num: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None,
) -> torch.Tensor:
    """One pretraining step on a gathered minibatch and its mask: the
    masked loss, its gradients, the AdamW update. Returns the loss,
    detached, on the device."""
    opt.zero_grad(set_to_none=True)
    logits, targets = model(cat, num, mask, train=True, generator=generator)
    loss = masked_loss(logits, targets, mask)
    loss.backward()
    opt.step()
    return loss.detach()


def pretrain_bert(
    model_config: ModelConfig,
    ds: EncodedDataset,
    steps: int = 1000,
    batch_size: int = 256,
    learning_rate: float = 3e-4,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> PretrainResult:
    """Pretrain on an encoded (unlabeled) dataset on ``device`` (the card
    unless "cpu"); returns the MLM params and the loss curve."""
    dev = resolve_device(device)
    model = init_params(build_mlm(model_config), seed).to(dev)
    opt = make_adamw(model.parameters(), learning_rate)
    n = ds.n
    batch_size = min(batch_size, n)
    cat = torch.from_numpy(ds.cat_ids).to(dev)
    num = torch.from_numpy(ds.numeric).to(dev)
    losses = []
    for step in range(1, steps + 1):
        idx = torch.from_numpy(batch_indices(n, batch_size, seed, step)).to(dev)
        mask = torch.from_numpy(step_mask(seed, step, batch_size, model)).to(dev)
        generator = dropout_generator(seed, step, dev)
        losses.append(mlm_step(model, opt, cat[idx], num[idx], mask, generator))
    curve = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    chunks = np.array_split(curve, min(10, len(curve))) if len(curve) else []
    return PretrainResult(
        params={k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        losses=[float(c.mean()) for c in chunks],
    )


def fine_tune_params(
    pretrain: PretrainResult, classifier: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Graft the pretrained trunk into a classifier's params (by name; the
    heads keep theirs), ready for ``fit(init_state=...)``."""
    return transfer_encoder_params(pretrain.params, classifier)


def save_pretrained(result: PretrainResult, path: str | Path) -> None:
    """``pretrained.msgpack``: the MLM params as flax's ``to_bytes``
    writes them, written atomically."""
    atomic_write(Path(path), msgpack.packb(unflatten_tree(result.params)))


def check_init_params(model_config: ModelConfig) -> None:
    """What ``train.init_params`` can graft into, refused with the JAX
    package's messages: not an ensemble's member axis, not a family other
    than bert."""
    if model_config.ensemble_size > 1:
        raise ValueError(
            "train.init_params grafts a pretrained trunk by parameter "
            "name, which cannot target the vmapped member axis of an "
            "ensemble — use ensemble_size=1 for fine-tuning runs"
        )
    if model_config.family != "bert":
        # The graft matches subtrees by NAME: mlp/linear share nothing and
        # ft_transformer/moe share block_i names they would silently absorb.
        raise ValueError(
            "train.init_params grafts a bert masked-LM trunk by name; "
            f"family {model_config.family!r} shares no trunk with it"
        )


def load_pretrained(path: str | Path, model_config: ModelConfig) -> dict[str, torch.Tensor]:
    """A ``pretrained.msgpack`` (either package's) -> the MLM params by
    name, f32 on the CPU, checked against ``model_config``'s masked-LM:
    its names and shapes, as flax's ``from_bytes`` into the MLM template
    checks them."""
    tree = msgpack.unpackb(Path(path).read_bytes())
    params = {k: v.float() for k, v in flatten_tree(tree).items()}
    load_params(build_mlm(model_config), params)  # raises on a mismatch
    return params


def load_pretrained_variables(
    path: str | Path, model_config: ModelConfig, classifier: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Read saved MLM params and graft them into a classifier's params."""
    check_init_params(model_config)
    return fine_tune_params(
        PretrainResult(params=load_pretrained(path, model_config), losses=[]),
        classifier,
    )
