"""Teacher -> student distillation at packaging time: the bulk student
and the quantized serving tier.

Port of the JAX package's ``train/distill.py``:

- ``distill_for_bulk`` fits a small mlp (the teacher's embed width, a
  ``(64, 64)`` trunk, no dropout) to the teacher's logits; ensembles and
  the transformer families ship it in their bundle, and
  ``parallel/bulk.py`` routes bulk sweeps through it where asked;
- ``distill_quant_student`` fits the hand-written student of
  ``ops/quant.py`` (one-hot embeds, one relu layer) the same way, then
  quantizes it (int8 dense, bf16 embeds), refits the calibration
  temperature on the quantized logits, grades the quantized tree on the
  held-out split (probability deltas, AUC delta, calibrated ECE) and
  stamps the promotion decision (``lifecycle/promote.py
  quant_tier_gates``). The grade is always of the quantized tree, never
  of the f32 master.

Both fits minimise the mean squared error to the teacher's logits with
``Adam`` (optax's ``adam`` arithmetic) over minibatches drawn uniformly
with replacement. The JAX fit is one ``lax.scan`` program; here a loop of
steps runs on the model's device with every tensor it touches there:
the step's indices come from a ``torch.Generator`` on that device seeded
from ``seed + 1``, and the loop reads nothing back to the host. The index
streams differ from jax.random's, so fits of the two packages agree in
fidelity, not in bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from mlops_tpu_torch.config import LifecycleConfig, ModelConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.lifecycle.promote import (
    expected_calibration_error,
    quant_tier_gates,
)
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.ops.quant import (
    QUANT_EMBED_DIM,
    QUANT_HIDDEN,
    init_quant_master,
    master_student_logits,
    quant_student_logits,
    quantize_student,
)
from mlops_tpu_torch.train.calibrate import fit_temperature
from mlops_tpu_torch.train.metrics import binary_metrics

# Rows per forward when a split is scored: rows are independent, so the
# chunking changes memory, not results.
LOGIT_CHUNK = 16_384


@dataclasses.dataclass
class DistillResult:
    student_config: ModelConfig
    student_params: dict[str, torch.Tensor]  # flattened flax names, CPU f32
    fidelity: dict[str, float]  # prob-space agreement + AUC delta on valid
    fit_s: float = 0.0  # wall seconds of the fit loop, device work included


@dataclasses.dataclass
class QuantDistillResult:
    """The quantized serving tier, graded at packaging time.

    - ``qparams``: the int8/bf16 dict ``ops/quant.py`` serves from;
    - ``fidelity``: post-quantization numbers on the held-out split
      (prob deltas against the teacher, AUC delta, calibrated ECE);
    - ``temperature``: the refit on the quantized logits;
    - ``gates``: the stamped decision plus the bounds it was graded by.
    """

    qparams: dict[str, torch.Tensor]
    fidelity: dict[str, float]
    temperature: float
    gates: dict[str, Any]
    fit_s: float = 0.0


class Adam:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root
    0) over a list of f32 tensors, in optax's arithmetic and order:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    each product and sum rounded on its own, the bias corrections in f32.
    ``torch.optim.Adam`` folds the corrections into the step size and the
    denominator, which rounds differently."""

    def __init__(
        self,
        params: list[torch.Tensor],
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ) -> None:
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(
            self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2)
        )
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(updates, -self.lr)
        torch._foreach_add_(self.params, updates)


def _device_split(ds: EncodedDataset, device: torch.device):
    return (
        torch.from_numpy(ds.cat_ids).to(device),
        torch.from_numpy(ds.numeric).to(device),
    )


@torch.no_grad()
def _chunked_logits(forward, ds: EncodedDataset, device, chunk: int) -> torch.Tensor:
    cat, num = _device_split(ds, device)
    outs = [
        forward(cat[lo: lo + chunk], num[lo: lo + chunk]).float()
        for lo in range(0, ds.n, chunk)
    ]
    return torch.cat(outs) if outs else torch.empty(0, device=device)


def teacher_logits(
    model: torch.nn.Module,
    ds: EncodedDataset,
    device: str | torch.device | None = None,
    chunk: int = LOGIT_CHUNK,
) -> torch.Tensor:
    """The model's eval logits over the whole dataset, ``chunk`` rows per
    forward, as an f32 tensor on ``device`` (the card unless "cpu")."""
    device = resolve_device(device)
    model = model.to(device).eval()
    return _chunked_logits(model, ds, device, chunk)


def _quant_logits_chunked(
    qparams: dict[str, torch.Tensor],
    ds: EncodedDataset,
    device: str | torch.device | None = None,
    chunk: int = LOGIT_CHUNK,
) -> torch.Tensor:
    """The quantized student's logits over a dataset, ``chunk`` rows per
    forward, on ``device``."""
    device = resolve_device(device)
    on_device = {k: v.to(device) for k, v in qparams.items()}
    return _chunked_logits(
        lambda c, x: quant_student_logits(on_device, c, x), ds, device, chunk
    )


def _fit(forward, leaves, target, cat, num, steps, batch_size, learning_rate, seed) -> float:
    """``steps`` Adam steps of the logit MSE, minibatches drawn on the
    device from ``seed + 1``; returns the loop's wall seconds (the device
    drained at the end)."""
    device = target.device
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    optimizer = Adam(leaves, learning_rate)
    n = target.shape[0]
    start = time.perf_counter()
    for _ in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=device)
        loss = torch.mean(torch.square(forward(cat[idx], num[idx]) - target[idx]))
        optimizer.step(list(torch.autograd.grad(loss, leaves)))
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return time.perf_counter() - start


def _fidelity(t_valid: np.ndarray, s_valid: np.ndarray) -> dict[str, float]:
    p_t = 1.0 / (1.0 + np.exp(-t_valid))
    p_s = 1.0 / (1.0 + np.exp(-s_valid))
    return {
        "mean_abs_prob_delta": float(np.mean(np.abs(p_t - p_s))),
        "max_abs_prob_delta": float(np.max(np.abs(p_t - p_s))),
    }


def _auc(logits: np.ndarray, labels: np.ndarray) -> float:
    return float(
        binary_metrics(torch.from_numpy(logits), torch.from_numpy(labels))["roc_auc"]
    )


def distill_for_bulk(
    teacher: torch.nn.Module,
    model_config: ModelConfig,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    hidden_dims: tuple[int, ...] = (64, 64),
    steps: int = 800,
    batch_size: int = 2048,
    learning_rate: float = 3e-3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> DistillResult:
    """Fit a small-mlp student to the teacher's logits on ``device`` (the
    card unless "cpu") and record its fidelity on the validation split:
    mean and max |Δprob| against the teacher and, with labels, both AUCs
    and their delta."""
    device = resolve_device(device)
    student_config = dataclasses.replace(
        model_config,
        family="mlp",
        ensemble_size=1,
        hidden_dims=tuple(hidden_dims),
        dropout=0.0,
    )
    target = teacher_logits(teacher, train_ds, device)
    student = init_params(build_model(student_config), seed).to(device)
    cat, num = _device_split(train_ds, device)
    fit_s = _fit(
        student, list(student.parameters()), target, cat, num,
        steps, batch_size, learning_rate, seed,
    )
    student.eval()
    t_valid = teacher_logits(teacher, valid_ds, device).cpu().numpy()
    s_valid = teacher_logits(student, valid_ds, device).cpu().numpy()
    fidelity = _fidelity(t_valid, s_valid)
    if valid_ds.labels is not None:
        lab = np.asarray(valid_ds.labels, np.float32)
        auc_t, auc_s = _auc(t_valid, lab), _auc(s_valid, lab)
        fidelity["teacher_roc_auc"] = auc_t
        fidelity["student_roc_auc"] = auc_s
        fidelity["roc_auc_delta"] = auc_s - auc_t
    return DistillResult(
        student_config=student_config,
        student_params={k: v.detach().cpu().float() for k, v in student.state_dict().items()},
        fidelity=fidelity,
        fit_s=fit_s,
    )


def distill_quant_student(
    teacher: torch.nn.Module,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    embed_dim: int = QUANT_EMBED_DIM,
    hidden: int = QUANT_HIDDEN,
    steps: int = 800,
    batch_size: int = 2048,
    learning_rate: float = 3e-3,
    seed: int = 0,
    lifecycle: LifecycleConfig | None = None,
    device: str | torch.device | None = None,
) -> QuantDistillResult:
    """Distill the teacher into the quantized serving tier on ``device``
    and grade it: fit the f32 master, quantize it, refit the temperature
    on the quantized logits, measure fidelity on the held-out split and
    stamp the ``quant_tier_gates`` decision with its bounds."""
    lifecycle = lifecycle or LifecycleConfig()
    device = resolve_device(device)
    target = teacher_logits(teacher, train_ds, device)
    master = {
        k: v.to(device).requires_grad_()
        for k, v in init_quant_master(seed, embed_dim, hidden).items()
    }
    cat, num = _device_split(train_ds, device)
    fit_s = _fit(
        lambda c, x: master_student_logits(master, c, x), list(master.values()),
        target, cat, num, steps, batch_size, learning_rate, seed,
    )
    qparams = quantize_student({k: v.detach() for k, v in master.items()})

    # Everything below grades the quantized tree, the bits that will
    # serve, never the f32 master.
    t_valid = teacher_logits(teacher, valid_ds, device).cpu().numpy()
    s_valid = _quant_logits_chunked(qparams, valid_ds, device).cpu().numpy()
    fidelity = _fidelity(t_valid, s_valid)
    temperature = 1.0
    if valid_ds.labels is not None:
        lab = np.asarray(valid_ds.labels, np.float32)
        temperature = fit_temperature(s_valid, lab)
        auc_t, auc_s = _auc(t_valid, lab), _auc(s_valid, lab)
        fidelity["teacher_roc_auc"] = auc_t
        fidelity["student_roc_auc"] = auc_s
        fidelity["roc_auc_delta"] = auc_s - auc_t
        fidelity["ece"] = expected_calibration_error(
            1.0 / (1.0 + np.exp(-s_valid / temperature)), lab
        )
    decision = quant_tier_gates(fidelity, lifecycle)
    gates = decision.as_dict() | {
        "max_auc_drop": lifecycle.max_auc_drop,
        "max_ece": lifecycle.max_ece,
    }
    return QuantDistillResult(
        qparams=qparams,
        fidelity=fidelity,
        temperature=float(temperature),
        gates=gates,
        fit_s=fit_s,
    )
