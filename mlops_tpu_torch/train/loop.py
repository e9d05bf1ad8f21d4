"""What every trainer shares: the loss, the EMA, the result record and
the metric sink (the JAX package's ``train/loop.py``, the parts the doc
trainer uses)."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class TrainResult:
    params: Any
    metrics: dict[str, float]  # metrics of the packaged params
    history: list[dict[str, float]]
    steps: int  # total steps trained
    packaged_step: int = 0  # the eval step the packaged params came from


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX computes it (``logaddexp(x, 0)``):
    exact at every x, where ``F.softplus`` returns x above its
    threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def sigmoid_bce(
    logits: torch.Tensor, labels: torch.Tensor, pos_weight: float = 1.0
) -> torch.Tensor:
    """Weighted sigmoid binary cross-entropy (mean); ``pos_weight``
    scales the positive-class term for class imbalance."""
    labels = labels.float()
    per_example = pos_weight * labels * softplus(-logits) + (
        1.0 - labels
    ) * softplus(logits)
    return per_example.mean()


@torch.no_grad()
def update_ema(
    ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor], decay: float
) -> None:
    """One Polyak step of the raw (biased) accumulator, in place:
    ``ema = decay * ema + (1 - decay) * params``."""
    for name, e in ema.items():
        e.mul_(decay).add_(params[name], alpha=1.0 - decay)


def debias_ema(
    ema: dict[str, torch.Tensor], decay: float, step: int
) -> dict[str, torch.Tensor]:
    """Bias-corrected Polyak average ``ema / (1 - decay^step)``, the
    correction in f32 as the JAX package computes it."""
    correction = float(np.float32(1.0) - np.float32(decay) ** np.float32(step))
    return {name: e / correction for name, e in ema.items()}


def packaged_or_raw(
    ema: dict[str, torch.Tensor] | None,
    params: dict[str, torch.Tensor],
    decay: float,
    step: int,
) -> dict[str, torch.Tensor]:
    """What ships and evaluates: the debiased EMA when enabled and at
    least one step has run, else the raw params."""
    return debias_ema(ema, decay, step) if decay and step > 0 else params


@contextlib.contextmanager
def metric_writers(
    metrics_path: str | Path | None, tensorboard_dir: str = ""
) -> Iterator[Callable[[dict], None]]:
    """The metric sink: yields ``emit(record)``, which appends one JSON
    line (``{"ts": ..., **record}``, flushed) to ``metrics_path`` as the
    JAX package's ``JsonlWriter`` does. TensorBoard
    (``train.tensorboard_dir``) is not ported and is refused, not
    dropped."""
    if tensorboard_dir:
        raise ValueError(
            "train.tensorboard_dir is not ported (ROADMAP.md, queue C): this "
            "package writes metrics.jsonl only; unset train.tensorboard_dir"
        )
    f = None
    if metrics_path:
        path = Path(metrics_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        f = path.open("a")

    def emit(record: dict) -> None:
        if f is not None:
            f.write(json.dumps({"ts": time.time(), **record}, default=float) + "\n")
            f.flush()

    try:
        yield emit
    finally:
        if f is not None:
            f.close()
