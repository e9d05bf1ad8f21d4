"""The dense single-record trainer (the JAX package's
``train/loop.py::fit``) and what every trainer shares: the loss, the
optimizer, the EMA, the result record and the metric sink.

``fit`` follows the JAX loop window by window, on one device:

- the encoded dataset is put on the device once, minibatches are
  gathered there from per-step indices (``batch_indices``: a function of
  the seed and the step, so the CPU and the card see the same batches and
  a resumed run sees the batches the interrupted one would have);
- dropout draws from a generator on the model's device seeded per step
  from (seed, step), the counterpart of ``fold_in`` (checkpoints then
  need no generator state);
- ``eval_every`` steps make a window, the last one shorter so the run
  takes exactly ``steps`` steps, resume included; after each window the
  validation split is scored and one record ``{"step", "train_loss",
  "validation_*_score"}`` is written;
- ``keep_best`` packages the strictly best validation ROC-AUC window's
  params, persisted beside the checkpoints; ``ema_decay`` packages and
  evaluates the debiased EMA;
- checkpoints every ``checkpoint_every`` steps and at the end.

jax.random's bits cannot be reproduced, so runs of the two packages are
compared statistically, not bit for bit. The step runs eagerly (no CUDA
graph: capturing it is ROADMAP A3), and the path launches no
hand-written kernel: the JAX trainer is plain ``jnp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mlops_tpu_torch.config import TrainConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.models import init_params
from mlops_tpu_torch.train import checkpoint as ckpt
from mlops_tpu_torch.train.metrics import binary_metrics
from mlops_tpu_torch.weights import load_params

# Validation rows per forward when a split is scored: rows are
# independent, so the chunking changes memory, not results.
EVAL_CHUNK_ROWS = 8192


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
    """The metric sink every trainer shares, as in the JAX package: yields
    ``emit(record)``, which appends one JSON line (``{"ts": ...,
    **record}``, flushed) to ``metrics_path`` as the JAX package's
    ``JsonlWriter`` does, and with ``tensorboard_dir`` (``train.
    tensorboard_dir``) also writes the record's numbers as TensorBoard
    scalars (``utils/tboard.py``). Both sinks close on every exit."""
    f = None
    if metrics_path:
        path = Path(metrics_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        f = path.open("a")
    tb = None
    if tensorboard_dir:
        from mlops_tpu_torch.utils.tboard import TensorBoardWriter

        tb = TensorBoardWriter(tensorboard_dir)

    def emit(record: dict) -> None:
        if f is not None:
            f.write(json.dumps({"ts": time.time(), **record}, default=float) + "\n")
            f.flush()
        if tb is not None:
            tb.write(record)

    try:
        yield emit
    finally:
        if f is not None:
            f.close()
        if tb is not None:
            tb.close()


def batch_indices(n_rows: int, batch: int, seed: int, step: int) -> np.ndarray:
    """Minibatch indices for ONE step, seeded by (seed, step), exactly as
    every trainer of the port draws them: the data order is a function of
    the step, so a resumed run sees the batches the interrupted one would
    have, and the CPU and the card see the same ones."""
    return np.random.default_rng((seed, step)).integers(0, n_rows, batch)


def dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout stream of one step on ``device``, seeded from (seed,
    step): the counterpart of the JAX loop's ``fold_in(rng, step)``. A
    layout trainer gives every rank the same generator and draws each
    mask whole before keeping the rank's block of it
    (``parallel/steps.py::ShardedStream``), so K ranks apply the masks one
    rank applies."""
    state = np.random.SeedSequence((seed, step, 1)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def training_loss(
    model: nn.Module,
    cat: torch.Tensor,
    num: torch.Tensor,
    lab: torch.Tensor,
    generator: torch.Generator | None = None,
    pos_weight: float = 1.0,
) -> torch.Tensor:
    """The JAX ``training_loss``: weighted BCE of the training forward,
    over ``[N]`` or an ensemble's ``[K, N]`` member logits (the mean of K
    independent member losses), plus every auxiliary the model returns
    (``loss_of``)."""
    out = model(cat, num, train=True, generator=generator)
    return loss_of(out, lab, pos_weight)


def loss_of(out, lab: torch.Tensor, pos_weight) -> torch.Tensor:
    """The loss of a training forward's output: BCE of the logits, then
    for a family with auxiliaries (``(logits, aux [(K,) blocks])``, the
    MoE's load-balance terms) the mean of each block's auxiliary over the
    members added in turn, as the JAX loss adds the mean of every sown
    leaf."""
    logits, aux = out if isinstance(out, tuple) else (out, None)
    loss = sigmoid_bce(logits, lab, pos_weight)
    if aux is not None:
        for leaf in aux.unbind(-1):
            loss = loss + leaf.mean()
    return loss


def lr_schedule(config: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(steps, warmup_steps + 1), 0.05 * lr)`` in its f32 arithmetic,
    operation by operation: a linear warmup from 0, then a cosine to
    ``0.05 * lr``. The cosine is the correctly rounded one of the f32
    argument; XLA's f32 cosine is not always, which leaves up to about
    two f32 ulps between the two schedules at some steps."""
    f32 = np.float32
    peak = config.learning_rate
    warmup = config.warmup_steps
    decay = max(config.steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else (peak * 0.05) / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1.0) - f32(max(count, 0)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        arg = f32(np.pi) * f32(min(count - warmup, decay)) / f32(decay)
        cosine = f32(0.5) * (f32(1.0) + f32(math.cos(float(arg))))
        return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule,
    weight_decay))`` over a module's parameters, in optax's arithmetic:

    - the gradients' global norm g over every leaf; they pass as they are
      when ``g < 1`` and are divided by ``g`` otherwise (optax's clip;
      ``clip_grad_norm_`` divides by ``g + 1e-6`` and is not the same);
    - ``torch.optim.AdamW`` with betas (0.9, 0.999) and eps 1e-8 outside
      the square root, decaying every parameter (optax masks none);
    - the learning rate of an update is the schedule at the count before
      it (optax evaluates it before its increment): the first update uses
      ``lr(0) = 0``.

    Under tensor parallelism (``parallel/steps.py``) a rank holds only its
    block of the parameters split over 'model' (``sharded[i]``): their
    norms are completed over ``group`` (the squares all-reduced, then the
    root), the replicated leaves counted once, so every rank clips by the
    norm optax takes over the logical arrays. On an axis of one rank the
    completed norm is the leaf's own (``sqrt(n * n) == n`` in IEEE f32).
    """

    def __init__(
        self,
        params: list[nn.Parameter],
        config: TrainConfig,
        sharded: list[bool] | None = None,
        group=None,
    ) -> None:
        self.params = list(params)
        self.sharded = [i for i, s in enumerate(sharded or []) if s]
        self.group = group
        self.schedule = lr_schedule(config)
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay,
        )
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norms = list(torch._foreach_norm(grads))
        if self.group is not None and self.sharded:
            import torch.distributed as dist

            part = torch.stack([norms[i] for i in self.sharded])
            squares = part * part
            dist.all_reduce(squares, group=self.group)
            for i, full in zip(self.sharded, torch.sqrt(squares).unbind()):
                norms[i] = full
        norm = torch.linalg.vector_norm(torch.stack(norms))
        torch._foreach_div_(grads, torch.where(norm < 1.0, torch.ones_like(norm), norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(model: nn.Module, config: TrainConfig) -> ClippedAdamW:
    """The JAX ``make_optimizer`` over ``model``'s parameters."""
    return ClippedAdamW(list(model.parameters()), config)


def _to_device(ds: EncodedDataset, device: torch.device):
    return (
        torch.from_numpy(ds.cat_ids).to(device),
        torch.from_numpy(ds.numeric).to(device),
        torch.from_numpy(np.asarray(ds.labels, np.float32)).to(device),
    )


def eval_logits(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    cat: torch.Tensor,
    num: torch.Tensor,
    chunk: int = EVAL_CHUNK_ROWS,
) -> torch.Tensor:
    """Eval logits of ``params`` applied to ``model`` over a whole split
    (rows, or the doc model's documents), ``chunk`` of them per forward."""
    with torch.inference_mode():
        chunks = [
            functional_call(model, params, (cat[lo: lo + chunk], num[lo: lo + chunk]))
            for lo in range(0, cat.shape[0], chunk)
        ]
    return torch.cat(chunks) if chunks else torch.empty(0, device=cat.device)


def evaluate(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    cat: torch.Tensor,
    num: torch.Tensor,
    lab: torch.Tensor,
) -> dict[str, float]:
    """The reference's five validation metrics of ``params`` on a split."""
    metrics = binary_metrics(eval_logits(model, params, cat, num), lab)
    return {f"validation_{k}_score": float(v) for k, v in metrics.items()}


def journal_max_step(path: Path) -> int:
    """Highest step already in a metrics.jsonl (0 when absent), so a
    resumed run appends no duplicate rows; unreadable lines are skipped."""
    best = 0
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return 0
    for line in lines:
        try:
            best = max(best, int(json.loads(line)["step"]))
        except (ValueError, KeyError, TypeError):
            continue
    return best


def train_step(
    model: nn.Module,
    optimizer: ClippedAdamW,
    config: TrainConfig,
    step: int,
    cat: torch.Tensor,
    num: torch.Tensor,
    lab: torch.Tensor,
    ema: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One step of ``fit`` on a gathered minibatch: the loss with step
    ``step``'s dropout stream, its gradients, the clipped AdamW update and
    (``ema``) the EMA update. Returns the loss, detached, on the device."""
    optimizer.zero_grad()
    generator = dropout_generator(config.seed, step, cat.device)
    loss = training_loss(model, cat, num, lab, generator, config.pos_weight)
    loss.backward()
    optimizer.step()
    if ema is not None:
        update_ema(ema, dict(model.named_parameters()), config.ema_decay)
    return loss.detach()


def fit(
    model: nn.Module,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    config: TrainConfig,
    init_state: dict[str, torch.Tensor] | None = None,
    metrics_path: str | Path | None = None,
    checkpoint_dir: str | Path | None = None,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Train ``model`` (a ``models.build_model`` module; initialized here
    from ``config.seed``, or from ``init_state``, a ``state_dict`` of its
    params — the JAX ``init_variables``, which the lifecycle retrain
    fine-tunes from —, and moved to ``device``, ``config.device`` when
    None: the card unless "cpu") on an encoded dataset; resume from the
    checkpoints in ``checkpoint_dir`` if any (a checkpoint wins over
    ``init_state``). The optimizer starts fresh either way. The result's
    params are the packaged ones on the CPU, by ``state_dict`` name.

    Under a launcher every rank trains the same model and reads the same
    checkpoints; only the coordinator writes checkpoints, metrics and
    event files, after every rank has read."""
    from mlops_tpu_torch.parallel.distributed import barrier, is_coordinator

    dev = resolve_device(device if device is not None else config.device)
    if init_state is None:
        model = init_params(model, config.seed)
    else:
        model = load_params(model, init_state)
    model = model.to(dev)
    params = dict(model.named_parameters())
    optimizer = make_optimizer(model, config)
    decay = config.ema_decay
    ema = {k: torch.zeros_like(p) for k, p in params.items()} if decay else None
    start_step = 0
    if checkpoint_dir is not None:
        start_step = ckpt.restore_train_state(checkpoint_dir, model, optimizer, ema)

    cat, num, lab = _to_device(train_ds, dev)
    vcat, vnum, vlab = _to_device(valid_ds, dev)
    n = cat.shape[0]
    base_window = max(1, min(config.eval_every, config.steps))

    # keep_best: the params of the highest-AUC window, persisted beside the
    # checkpoints so a resume continues the comparison.
    best_auc, best_params, best_record = float("-inf"), None, None
    if config.keep_best and checkpoint_dir is not None:
        restored = ckpt.load_best(checkpoint_dir, params)
        if restored is not None:
            best_params, best_record = restored
            best_auc = best_record["validation_roc_auc_score"]
    journal_floor = journal_max_step(Path(metrics_path)) if metrics_path else 0
    barrier()  # no rank reads a checkpoint the coordinator is writing
    writer = is_coordinator()
    save_dir = checkpoint_dir if writer else None
    if not writer:
        metrics_path = None

    history: list[dict[str, float]] = []
    step = last_ckpt = start_step
    with metric_writers(metrics_path, config.tensorboard_dir if writer else "") as emit:
        while step < config.steps:
            window = min(base_window, config.steps - step)
            steps = range(step + 1, step + window + 1)
            idx = torch.from_numpy(
                np.stack([batch_indices(n, config.batch_size, config.seed, s) for s in steps])
            ).to(dev)
            losses = torch.stack([
                train_step(model, optimizer, config, s, cat[idx[i]], num[idx[i]],
                           lab[idx[i]], ema)
                for i, s in enumerate(steps)
            ])
            step += window
            eval_params = packaged_or_raw(ema, params, decay, step)
            record = {"step": step, "train_loss": float(losses.mean())}
            record.update(evaluate(model, eval_params, vcat, vnum, vlab))
            if config.keep_best and record["validation_roc_auc_score"] > best_auc:
                # strict >: a plateau keeps the first window of its value
                best_auc = record["validation_roc_auc_score"]
                best_params = {k: v.detach().cpu().clone() for k, v in eval_params.items()}
                best_record = record
                if save_dir is not None:
                    ckpt.save_best(save_dir, best_params, best_record)
            history.append(record)
            if step > journal_floor:  # no duplicate rows on resume
                emit(record)
            if save_dir is not None and step - last_ckpt >= config.checkpoint_every:
                ckpt.save_checkpoint(save_dir, ckpt.train_state(model, optimizer, ema), step)
                last_ckpt = step
        if save_dir is not None and step > last_ckpt:
            ckpt.save_checkpoint(save_dir, ckpt.train_state(model, optimizer, ema), step)

    serving = packaged_or_raw(ema, params, decay, step)
    if best_params is not None:
        # The metrics and the params come from the same (best) window.
        final, packaged = best_record, best_params
    else:
        final = history[-1] if history else evaluate(model, serving, vcat, vnum, vlab)
        packaged = {k: v.detach().cpu().clone() for k, v in serving.items()}
    return TrainResult(
        params=packaged,
        metrics={k: v for k, v in final.items() if k.startswith("validation_")},
        history=history,
        steps=step,
        packaged_step=int(final.get("step", step)),
    )
