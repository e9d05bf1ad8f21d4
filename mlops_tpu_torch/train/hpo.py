"""Hyperparameter search: the JAX package's ``train/hpo.py`` on one card.

The JAX package ``vmap``s its whole per-trial training loop over a
stacked trial axis: trials of one architecture differ only in continuous
hyperparameters (learning rate, weight decay, positive-class weight), so T
trials train as one compiled program. Here the trial axis is the same
leading ``[T, ...]`` axis, trained by ``TrialStack``:

- every trial's parameters, AdamW moments and EMA live in one ``[T, P]``
  f32 buffer each; the module's parameters are views of a split of it;
- one training step is one program over all T trials: the minibatches
  gathered per trial (``[T, B]`` indices), the model's forward and loss
  under ``torch.func.vmap`` over ``functional_call`` of the same module
  (each trial reads its own rows with its own weights: a batched matmul
  per layer), one backward, and the optimizer as a few elementwise passes
  over ``[T, P]``; no Python loop runs over the trials inside a step and
  nothing is read back to the host, so the kernels per step do not grow
  with T and the step can be captured in a CUDA graph later;
- the optimizer is optax's ``chain(clip_by_global_norm(1.0),
  adamw(schedule, weight_decay=wd))`` with ``lr[T]`` and ``wd[T]``, in its
  arithmetic: each trial's norm over all of its parameters, the schedule
  evaluated at the count before the increment, every parameter decayed;
  the schedule is the JAX sweep's hand-written warmup-cosine
  (``warmup = max(1, horizon // 20)``, a 0.05 floor), not ``train``'s;
- batches and dropout are keyed by (the trial's key, the global step):
  a counter-based hash on the device (``CounterStream``, ``batch_rows``),
  so a trial draws the same rows and masks beside any other trials or
  alone, on the CPU or the card, and a trial SHA continues never replays
  an earlier rung's batches.

``run_hpo`` (random search), ``run_sha`` (successive halving) and
``run_architecture_hpo`` (groups of architectures, resumable per group)
select exactly as the JAX package does. On a mesh (``mesh=``, the
``tune`` command's data mesh over the world's ranks) the trial axis
splits over 'data' as the JAX package shards it: the trials pad up to a
multiple of the axis (random search: the leading hyperparameters cycled
with seeds of their own, SHA: each rung's survivors cycled whole), each
rank trains its block of the stack, and the metrics, a rung's survivors'
state and the winner's params are exchanged over the axis. jax.random's bits cannot be
reproduced, so initial params and batch indices can be injected (``init``,
``index_source``): the tests feed the JAX sweep's own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, vmap

from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.models import FAMILIES, build_model, init_params
from mlops_tpu_torch.parallel.distributed import is_coordinator
from mlops_tpu_torch.parallel.sharding import gather_tensor, row_block
from mlops_tpu_torch.train.loop import EVAL_CHUNK_ROWS, loss_of
from mlops_tpu_torch.train.metrics import binary_metrics
from mlops_tpu_torch.utils.io import atomic_write

# optax.adamw's defaults.
B1, B2, EPS = 0.9, 0.999, 1e-8

# (original trial ids of the live rows, global step) -> [len(ids), B] row
# indices: the test seam that feeds the trainer another sweep's batches.
IndexSource = Callable[[np.ndarray, int], Any]


@dataclasses.dataclass
class HPOResult:
    best_index: int
    best_hyperparams: dict[str, Any]  # floats, plus structural fields
    # (family/hidden_dims/...) when an architecture sweep selected them
    best_params: dict[str, torch.Tensor]  # the winning trial's, by name, CPU
    best_metrics: dict[str, float]
    trials: list[dict[str, Any]]  # per-trial {hyperparams, metrics}


def parse_architecture_spec(spec: str, base: ModelConfig) -> ModelConfig:
    """One ``hpo.architectures`` entry -> a ModelConfig: comma-separated
    ``field=value`` overrides of any ModelConfig field, tuples joined by
    ``x`` (``hidden_dims=64x64``), values coerced by the field's current
    type. The JAX package's grammar and errors."""
    overrides: dict[str, Any] = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        field, sep, raw = pair.partition("=")
        field = field.strip()
        if not sep or not hasattr(base, field):
            raise ValueError(
                f"bad architecture spec {spec!r}: "
                f"{pair!r} is not a ModelConfig field=value override"
            )
        current = getattr(base, field)
        if isinstance(current, tuple):
            inner = type(current[0]) if current else int
            overrides[field] = tuple(
                inner(x) for x in raw.strip().split("x") if x.strip()
            )
        elif isinstance(current, bool):
            overrides[field] = raw.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            overrides[field] = int(raw)
        elif isinstance(current, float):
            overrides[field] = float(raw)
        else:
            overrides[field] = raw.strip()
    result = dataclasses.replace(base, **overrides)
    if result.family not in FAMILIES:
        raise ValueError(
            f"bad architecture spec {spec!r}: family {result.family!r} is "
            f"not vmappable (Flax families: {FAMILIES})"
        )
    return result


def sample_hyperparams(config: HPOConfig) -> dict[str, np.ndarray]:
    """Log-uniform lr / weight decay, uniform pos_weight: stacked ``[T]``
    arrays from ``config.seed``, bit for bit the JAX package's draw."""
    rng = np.random.default_rng(config.seed)
    t = config.trials
    return {
        "learning_rate": 10 ** rng.uniform(*config.lr_log10, t),
        "weight_decay": 10 ** rng.uniform(*config.wd_log10, t),
        "pos_weight": rng.uniform(*config.pos_weight_range, t),
    }


def trial_seeds(seed: int, trials: int) -> np.ndarray:
    """Per trial (init seed, stream key), both 32-bit, from (seed, trial):
    the counterpart of ``jax.random.split(PRNGKey(seed), trials)``."""
    return np.stack([
        np.random.SeedSequence((seed, i)).generate_state(2) for i in range(trials)
    ]).astype(np.int64)


# ------------------------------------------------- counter-based streams
_M32 = 0xFFFFFFFF


def hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) of int64
    values in [0, 2**32), elementwise, on any device. Both multipliers
    are odd and below 2**31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def site_bases(keys: torch.Tensor, step: torch.Tensor, sites: int) -> torch.Tensor:
    """``[..., sites]`` 32-bit bases of (trial key, global step, site):
    site 0 draws the batch rows, sites 1.. the dropout masks, each from
    its base onwards."""
    site = torch.arange(sites, device=keys.device)
    return hash32(hash32(hash32(keys) ^ (step & _M32))[..., None] ^ site)


def _counters(base: torch.Tensor, n: int) -> torch.Tensor:
    return hash32((base[..., None] + torch.arange(n, device=base.device)) & _M32)


def batch_rows(bases: torch.Tensor, batch: int, n_rows: int) -> torch.Tensor:
    """Row indices ``[T, batch]`` in [0, n_rows) from the trials' site
    bases ``[T, sites]`` (``site_bases``): a function of (key, step)
    alone, on the device (multiply-shift of a 32-bit hash)."""
    return (_counters(bases[:, 0], batch) * n_rows) >> 32


class CounterStream:
    """The dropout stream of one trial and one step: each ``uniform``
    call is the next site, its counters hashed from that site's base
    (``site_bases``, keyed by the trial's key and the global step). Pure
    arithmetic, so it runs under ``torch.func.vmap`` with batched bases
    (one stream per trial), where a ``torch.Generator`` cannot."""

    def __init__(self, bases: torch.Tensor) -> None:
        self.bases, self.site = bases, 0

    def uniform(
        self, shape: Sequence[int], device: torch.device, rows: int = 0,
        split: int | None = None,
    ) -> torch.Tensor:
        self.site += 1
        bits = _counters(self.bases[self.site], math.prod(shape)) >> 8
        return (bits.to(torch.float32) * 2.0**-24).reshape(tuple(shape))


# ------------------------------------------------------ the trial stack
def _schedule(lr: torch.Tensor, count: torch.Tensor, horizon: int) -> torch.Tensor:
    """The JAX sweep's warmup-cosine at ``count`` for every trial's peak
    ``lr [T]``, in f32: linear warmup over ``max(1, horizon // 20)``
    steps, then a cosine to 0.05 of the peak at ``horizon``."""
    warmup = max(1, horizon // 20)
    step = count.to(torch.float32)
    warm = lr * step / warmup
    progress = torch.clamp((step - warmup) / max(horizon - warmup, 1), 0.0, 1.0)
    cosine = lr * (0.05 + 0.95 * 0.5 * (1.0 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup, warm, cosine)


@dataclasses.dataclass
class SweepData:
    """A split on the device: training rows, validation rows."""

    cat: torch.Tensor
    num: torch.Tensor
    lab: torch.Tensor
    vcat: torch.Tensor
    vnum: torch.Tensor
    vlab: torch.Tensor

    @classmethod
    def put(cls, train_ds: EncodedDataset, valid_ds: EncodedDataset, device) -> "SweepData":
        def up(ds):
            return (
                torch.from_numpy(ds.cat_ids).to(device),
                torch.from_numpy(ds.numeric).to(device),
                torch.from_numpy(np.asarray(ds.labels, np.float32)).to(device),
            )

        return cls(*up(train_ds), *up(valid_ds))


class TrialStack:
    """T trials of one architecture trained stacked on one device.

    ``hp`` holds the trials' ``learning_rate``, ``weight_decay`` and
    ``pos_weight`` ``[T]``; ``seeds`` their (init seed, stream key)
    (``trial_seeds``); ``horizon`` the schedule's span. ``init`` (one
    param dict per trial, by name) replaces the seeded flax-initializer
    init; ``index_source`` replaces the device-side batch draw."""

    def __init__(
        self,
        model_config: ModelConfig,
        train_config: TrainConfig,
        hp: dict[str, np.ndarray],
        seeds: np.ndarray,
        horizon: int,
        data: SweepData,
        device: torch.device,
        init: Sequence[dict[str, torch.Tensor]] | None = None,
        index_source: IndexSource | None = None,
        trial_ids: np.ndarray | None = None,
    ) -> None:
        self.model = build_model(model_config).to(device)
        self.names, self.shapes, self.sizes = [], [], []
        for name, p in self.model.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            self.sizes.append(p.numel())
        t = len(seeds)
        if init is None:
            init = [
                dict(init_params(build_model(model_config), int(s[0])).named_parameters())
                for s in seeds
            ]
        flat = torch.stack([
            torch.cat([init[i][name].detach().float().reshape(-1) for name in self.names])
            for i in range(t)
        ])
        self.flat = flat.to(device).requires_grad_(True)
        self.mu = torch.zeros_like(self.flat, requires_grad=False)
        self.nu = torch.zeros_like(self.mu)
        self.decay = train_config.ema_decay
        self.ema = torch.zeros_like(self.mu) if self.decay else None
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.steps_done = 0
        f32 = dict(dtype=torch.float32, device=device)
        self.lr = torch.as_tensor(np.asarray(hp["learning_rate"], np.float32), **f32)
        self.wd = torch.as_tensor(np.asarray(hp["weight_decay"], np.float32), **f32)
        self.pw = torch.as_tensor(np.asarray(hp["pos_weight"], np.float32), **f32)
        self.keys = torch.as_tensor(seeds[:, 1], dtype=torch.int64, device=device)
        # The original trial of each live row.
        self.trial_ids = np.arange(t) if trial_ids is None else np.asarray(trial_ids)
        self.horizon = horizon
        self.batch = train_config.batch_size
        self.data = data
        self.device = device
        self.index_source = index_source
        # Sites of one step: the batch rows, then at most three dropouts
        # per module (the blocks drop after attention, on its weights and
        # after the GELU).
        self.sites = 1 + 3 * len(list(self.model.modules()))
        self._loss_fn = vmap(self._trial_loss)

    @property
    def trials(self) -> int:
        return self.flat.shape[0]

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """``[T, P]`` -> each parameter's ``[T, *shape]`` view, by name."""
        t = flat.shape[0]
        return {
            name: piece.view(t, *shape)
            for name, shape, piece in zip(
                self.names, self.shapes, flat.split(self.sizes, dim=1)
            )
        }

    def _trial_loss(self, params, cat, num, lab, pos_weight, bases):
        out = functional_call(
            self.model, params, (cat, num),
            {"train": True, "generator": CounterStream(bases)},
        )
        return loss_of(out, lab, pos_weight)

    def loss_and_grad(self):
        """Every trial's loss ``[T]`` and gradient ``[T, P]`` at the next
        step."""
        bases = site_bases(self.keys, self.count, self.sites)
        if self.index_source is None:
            idx = batch_rows(bases, self.batch, self.data.cat.shape[0])
        else:
            idx = torch.as_tensor(
                np.asarray(self.index_source(self.trial_ids, self.steps_done)),
                dtype=torch.int64,
            ).to(self.device)
        d = self.data
        losses = self._loss_fn(
            self.views(self.flat), d.cat[idx], d.num[idx], d.lab[idx], self.pw, bases
        )
        (grad,) = torch.autograd.grad(losses.sum(), self.flat)
        return losses.detach(), grad

    @torch.no_grad()
    def apply(self, grad: torch.Tensor) -> None:
        """One optax update of every trial: global-norm clip at 1, Adam
        moments and bias corrections, decoupled weight decay, the
        schedule at the count before its increment; then the EMA."""
        norm = torch.sqrt(torch.sum(grad * grad, dim=1, keepdim=True))
        g = torch.where(norm < 1.0, grad, grad / norm)
        self.mu.copy_((1 - B1) * g + B1 * self.mu)
        self.nu.copy_((1 - B2) * (g * g) + B2 * self.nu)
        count_inc = (self.count + 1).to(torch.float32)
        mu_hat = self.mu / (1 - torch.pow(B1, count_inc))
        nu_hat = self.nu / (1 - torch.pow(B2, count_inc))
        update = mu_hat / (torch.sqrt(nu_hat) + EPS) + self.wd[:, None] * self.flat
        lr = _schedule(self.lr, self.count, self.horizon)
        self.flat.add_(-lr[:, None] * update)
        self.count += 1
        self.steps_done += 1
        if self.ema is not None:
            self.ema.copy_(self.decay * self.ema + (1.0 - self.decay) * self.flat)

    def step(self) -> torch.Tensor:
        """One training step of every trial; their losses ``[T]``, on the
        device."""
        losses, grad = self.loss_and_grad()
        self.apply(grad)
        return losses

    def run(self, steps: int) -> torch.Tensor:
        """``steps`` more steps; the losses ``[steps, T]`` on the device."""
        return torch.stack([self.step() for _ in range(steps)])

    @torch.no_grad()
    def eval_params(self) -> torch.Tensor:
        """What each trial is graded and packaged by: the EMA debiased by
        ``1 - decay**steps`` when enabled, else the raw params."""
        if self.ema is None:
            return self.flat.detach()
        return self.ema / (1.0 - self.decay**self.steps_done)

    @torch.no_grad()
    def metrics(self, flat: torch.Tensor) -> dict[str, np.ndarray]:
        """The five validation metrics of every trial's ``flat`` params:
        ``{name: [T]}`` (``roc_auc``, ...)."""
        t = flat.shape[0]
        d = self.data
        views = self.views(flat)
        chunk = max(1, EVAL_CHUNK_ROWS // t)

        def forward(params, cat, num):
            return functional_call(self.model, params, (cat, num))

        logits = torch.cat([
            vmap(forward, in_dims=(0, None, None))(
                views, d.vcat[lo: lo + chunk], d.vnum[lo: lo + chunk]
            )
            for lo in range(0, d.vcat.shape[0], chunk)
        ], dim=1)
        rows = [binary_metrics(logits[i], d.vlab) for i in range(t)]
        return {k: np.asarray([float(r[k]) for r in rows]) for k in rows[0]}

    def params_of(self, flat: torch.Tensor, row: int) -> dict[str, torch.Tensor]:
        """One trial's params, by name, on the CPU."""
        return {
            name: v[row].detach().float().cpu().clone()
            for name, v in self.views(flat).items()
        }

    @torch.no_grad()
    def gather_trials(self, group) -> None:
        """Every rank's block of the stack, concatenated over ``group`` in
        rank order (the data axis of a mesh): then every rank holds the
        whole padded stack, ready for ``keep``."""
        from mlops_tpu_torch.parallel.collectives import all_gather_cat

        def cat(t):
            return all_gather_cat(t, 0, group)

        self.flat = cat(self.flat.detach()).requires_grad_(True)
        self.mu, self.nu = cat(self.mu), cat(self.nu)
        if self.ema is not None:
            self.ema = cat(self.ema)
        self.lr, self.wd, self.pw, self.keys = (
            cat(self.lr), cat(self.wd), cat(self.pw), cat(self.keys)
        )
        ids = torch.as_tensor(self.trial_ids, dtype=torch.int64, device=self.device)
        self.trial_ids = cat(ids).cpu().numpy()

    @torch.no_grad()
    def keep(self, rows: np.ndarray) -> None:
        """Continue only the trials at ``rows`` (local indices, in that
        order), their optimizer state and EMA with them: one gather per
        buffer on the device."""
        rows = np.array(rows, dtype=np.int64)  # a copy: rows may be a reversed view
        sel = torch.as_tensor(rows, device=self.device)
        self.flat = self.flat.detach()[sel].requires_grad_(True)
        self.mu, self.nu = self.mu[sel], self.nu[sel]
        if self.ema is not None:
            self.ema = self.ema[sel]
        self.lr, self.wd, self.pw, self.keys = (
            self.lr[sel], self.wd[sel], self.pw[sel], self.keys[sel]
        )
        self.trial_ids = self.trial_ids[rows]


# ------------------------------------------------------------- sweeps
def select_best(objective: np.ndarray, name: str) -> int:
    """The index of the best finite objective; a non-finite one never
    wins, and all non-finite raises with the JAX package's message."""
    finite = np.isfinite(objective)
    if not finite.any():
        raise RuntimeError(
            f"all {len(objective)} trials produced non-finite "
            f"{name}: {objective.tolist()}"
        )
    return int(np.argmax(np.where(finite, objective, -np.inf)))


def _records(hp, metrics, rows, ids) -> list[dict[str, Any]]:
    return [
        {
            "hyperparams": {k: float(v[gi]) for k, v in hp.items()},
            "metrics": {f"validation_{k}_score": float(v[li]) for k, v in metrics.items()},
        }
        for li, gi in zip(rows, ids)
    ]


def run_hpo(
    model_config: ModelConfig,
    train_config: TrainConfig,
    hpo_config: HPOConfig,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    device: str | torch.device | None = None,
    init: Sequence[dict[str, torch.Tensor]] | None = None,
    index_source: IndexSource | None = None,
    mesh=None,
) -> HPOResult:
    """Train all trials stacked for ``hpo.steps`` steps and pick the
    objective winner; ``hpo.strategy="sha"`` routes to ``run_sha``. On a
    ``mesh`` the trials pad up to a multiple of its 'data' axis (the
    hyperparameters cycled, the seeds each trial's own; ``init`` then
    covers the padded count) and each rank trains its block; the padded
    trials are dropped before selection."""
    if hpo_config.strategy == "sha":
        return run_sha(
            model_config, train_config, hpo_config, train_ds, valid_ds,
            device=device, init=init, index_source=index_source, mesh=mesh,
        )
    if hpo_config.strategy != "random":
        raise ValueError(
            f"hpo.strategy must be 'random' or 'sha', not "
            f"{hpo_config.strategy!r}"
        )
    device = resolve_device(device if device is not None else train_config.device)
    t = hpo_config.trials
    hp = sample_hyperparams(hpo_config)
    axis = _data_axis(mesh)
    t_run = ((t + axis - 1) // axis) * axis
    # np.resize cycles the leading trials, even past the trial count.
    hp_run = {k: np.resize(v, t_run) for k, v in hp.items()}
    local = np.arange(t_run)[row_block(t_run, mesh)]
    stack = TrialStack(
        model_config, train_config, {k: v[local] for k, v in hp_run.items()},
        trial_seeds(hpo_config.seed, t_run)[local],
        hpo_config.steps, SweepData.put(train_ds, valid_ds, device), device,
        init=None if init is None else [init[i] for i in local],
        index_source=index_source, trial_ids=local,
    )
    stack.run(hpo_config.steps)
    final = stack.eval_params()
    metrics = {k: v[:t] for k, v in _gather_metrics(stack.metrics(final), mesh, device).items()}
    best = select_best(metrics[hpo_config.objective], hpo_config.objective)
    trials = _records(hp, metrics, range(t), range(t))
    return HPOResult(
        best_index=best,
        best_hyperparams=trials[best]["hyperparams"],
        best_params=_owner_params(stack, final, best, len(local), mesh),
        best_metrics=trials[best]["metrics"],
        trials=trials,
    )


def _data_axis(mesh) -> int:
    return mesh.size("data") if mesh is not None else 1


def _gather_metrics(metrics: dict[str, np.ndarray], mesh, device) -> dict[str, np.ndarray]:
    """Every rank's trials' metrics, concatenated over 'data'."""
    if mesh is None:
        return metrics
    return {
        k: gather_tensor(torch.as_tensor(v, device=device), ("data",), mesh).cpu().numpy()
        for k, v in metrics.items()
    }


def _owner_params(stack: TrialStack, flat: torch.Tensor, row: int, block: int,
                  mesh) -> dict[str, torch.Tensor]:
    """The params of padded row ``row``, on every rank: broadcast from the
    rank of 'data' that trains it (each holds ``block`` rows)."""
    if mesh is None:
        return stack.params_of(flat, row)
    import torch.distributed as dist

    owner, local = divmod(row, block)
    params = stack.params_of(flat, local if owner == mesh.index("data") else 0)
    src = mesh.axis_ranks["data"][owner]
    out = {}
    for name, value in params.items():
        value = value.to(stack.device)
        dist.broadcast(value, src=src, group=mesh.group("data"))
        out[name] = value.cpu()
    return out


def sha_plan(hpo_config: HPOConfig) -> tuple[list[int], int, int]:
    """Successive halving's (survivor counts per rung, steps per rung,
    horizon), as the JAX package computes them: the rung length keeps the
    total step budget at most ``trials * steps``."""
    n0 = hpo_config.trials
    eta = max(2, hpo_config.eta)
    rungs = max(1, hpo_config.sha_rungs)
    counts = [max(1, n0 // eta**r) for r in range(rungs)]
    rung_steps = max(1, (n0 * hpo_config.steps) // sum(counts))
    return counts, rung_steps, rung_steps * rungs


def run_sha(
    model_config: ModelConfig,
    train_config: TrainConfig,
    hpo_config: HPOConfig,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    device: str | torch.device | None = None,
    init: Sequence[dict[str, torch.Tensor]] | None = None,
    index_source: IndexSource | None = None,
    mesh=None,
) -> HPOResult:
    """Successive halving at random search's step budget: train every
    candidate one rung stacked, keep the top ``1/eta`` by the objective,
    continue only the survivors (optimizer state, EMA and all) on the
    schedule spanned over the whole horizon. Trials eliminated at rung r
    are recorded with the metrics, rung and steps they died with. On one
    device no survivor set is padded; on a ``mesh`` each rung's set pads
    up to a multiple of the 'data' axis with cycled duplicates (the JAX
    ``pad_to_axis``: they train whole rungs and are dropped at
    selection), each rank trains its block, and after a rung the stack is
    gathered over the axis before the survivors are taken."""
    device = resolve_device(device if device is not None else train_config.device)
    n0 = hpo_config.trials
    eta = max(2, hpo_config.eta)
    counts, rung_steps, horizon = sha_plan(hpo_config)
    rungs = len(counts)
    hp = sample_hyperparams(hpo_config)
    axis = _data_axis(mesh)

    def pad_to_axis(idx: np.ndarray) -> np.ndarray:
        return np.resize(idx, ((len(idx) + axis - 1) // axis) * axis)

    live = pad_to_axis(np.arange(n0))  # indices into the original trials
    local = live[row_block(len(live), mesh)]
    seeds = trial_seeds(hpo_config.seed, n0)
    stack = TrialStack(
        model_config, train_config, {k: v[local] for k, v in hp.items()}, seeds[local],
        horizon, SweepData.put(train_ds, valid_ds, device), device,
        init=None if init is None else [init[i] for i in local],
        index_source=index_source, trial_ids=local,
    )
    trials: list[dict[str, Any]] = [None] * n0  # filled at elimination
    valid_k = n0
    for r in range(rungs):
        stack.run(rung_steps)
        eval_flat = stack.eval_params()
        metrics = _gather_metrics(stack.metrics(eval_flat), mesh, device)
        objective = metrics[hpo_config.objective][:valid_k]
        finite = np.isfinite(objective)
        if not finite.any():
            raise RuntimeError(
                f"sha rung {r}: all {valid_k} trials produced non-finite "
                f"{hpo_config.objective}: {objective.tolist()}"
            )
        ranked = np.argsort(np.where(finite, objective, -np.inf))[::-1]
        keep = max(1, valid_k // eta) if r < rungs - 1 else valid_k
        # Every live trial's record as of THIS rung (survivors get
        # overwritten at later rungs with fresher numbers).
        for local_i, record in enumerate(
            _records(hp, metrics, range(valid_k), live)
        ):
            trials[int(live[local_i])] = {
                **record, "rung": r, "steps": stack.steps_done,
            }
        if r == rungs - 1:
            best_local = int(ranked[0])
            break
        survivors = ranked[:keep]
        if mesh is not None:
            stack.gather_trials(mesh.group("data"))
        # np.resize cycles the survivors exactly as pad_to_axis cycles live.
        rows = np.resize(survivors, len(pad_to_axis(survivors)))
        live = live[rows]
        stack.keep(rows[row_block(len(rows), mesh)])
        valid_k = keep
    best = int(live[best_local])
    return HPOResult(
        best_index=best,
        best_hyperparams=trials[best]["hyperparams"],
        best_params=_owner_params(stack, eval_flat, best_local, stack.trials, mesh),
        best_metrics=trials[best]["metrics"],
        trials=trials,
    )


# -------------------------------------------------- architecture groups
def _dataset_digest(ds: EncodedDataset) -> str:
    """Content digest of an encoded dataset (row count alone is not an
    identity: new data of the same size must not restore stale groups)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(ds.cat_ids).tobytes())
    h.update(np.ascontiguousarray(ds.numeric).tobytes())
    if ds.labels is not None:
        h.update(np.ascontiguousarray(ds.labels).tobytes())
    return h.hexdigest()


def _group_fingerprint(
    cfg: ModelConfig, group_hpo: HPOConfig, train_config: TrainConfig, train_ds
) -> str:
    """Everything a finished group's cached result is valid for: the full
    group ModelConfig, the whole sweep config, the training recipe (the
    device it ran on aside: it changes where, not what) and the dataset's
    identity."""
    train = dataclasses.asdict(train_config)
    train.pop("device")
    return json.dumps(
        {
            "model": dataclasses.asdict(cfg),
            "hpo": dataclasses.asdict(group_hpo),
            "train": train,
            "rows": train_ds.n,
            "data_digest": _dataset_digest(train_ds),
        },
        sort_keys=True,
        default=str,
    )


def _save_group_result(resume_dir: Path, g: int, fingerprint: str, res: HPOResult) -> None:
    """Persist a finished group (its record and the winner's params, in
    the port's ``torch.save`` format) so a retried sweep skips it."""
    directory = Path(resume_dir) / "hpo_groups"
    directory.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(res.best_params, buf)
    atomic_write(directory / f"group_{g}.pt", buf.getvalue())
    atomic_write(
        directory / f"group_{g}.json",
        json.dumps(
            {
                "fingerprint": fingerprint,
                "best_index": res.best_index,
                "best_hyperparams": res.best_hyperparams,
                "best_metrics": res.best_metrics,
                "trials": res.trials,
            },
            default=float,
        ).encode(),
    )


def _load_group_result(
    resume_dir: Path, g: int, fingerprint: str, cfg: ModelConfig
) -> HPOResult | None:
    """A finished group restored when its fingerprint still matches and
    its params fit the group's model; None on any mismatch or unreadable
    or absent file (recompute)."""
    directory = Path(resume_dir) / "hpo_groups"
    try:
        meta = json.loads((directory / f"group_{g}.json").read_text())
        if meta["fingerprint"] != fingerprint:
            return None
        params = torch.load(
            io.BytesIO((directory / f"group_{g}.pt").read_bytes()),
            map_location="cpu", weights_only=True,
        )
        want = build_model(cfg).state_dict()
        if set(params) != set(want) or any(
            params[k].shape != want[k].shape for k in want
        ):
            return None
        return HPOResult(
            best_index=int(meta["best_index"]),
            best_hyperparams=meta["best_hyperparams"],
            best_params=params,
            best_metrics=meta["best_metrics"],
            trials=meta["trials"],
        )
    except (OSError, RuntimeError, ValueError, KeyError, TypeError, AttributeError):
        return None


def run_architecture_hpo(
    model_config: ModelConfig,
    train_config: TrainConfig,
    hpo_config: HPOConfig,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    device: str | torch.device | None = None,
    resume_dir: str | Path | None = None,
    seams: Callable[[int, ModelConfig], dict[str, Any]] | None = None,
    mesh=None,
) -> tuple[ModelConfig, HPOResult]:
    """Loop architecture groups, stack trials within each. Each
    ``hpo.architectures`` spec is one group of ``hpo.trials`` trials,
    seeded ``seed + g``; the winner is the single best trial over every
    group by the same objective. Returns ``(winning ModelConfig, merged
    HPOResult)``: ``best_hyperparams`` carries the structural choices
    (family and every overridden field, tuples ``x``-joined) beside the
    continuous ones, each trial record gains ``group``/``architecture``,
    and the best index is offset into the merged list. With
    ``resume_dir`` a finished group persists and a rerun restores it
    without training. ``seams(g, cfg)`` may give a group its
    ``init``/``index_source`` (tests). ``mesh`` splits every group's
    trials over its 'data' axis; only the coordinator persists groups."""
    seams = seams or (lambda g, cfg: {})
    if not hpo_config.architectures:
        return model_config, run_hpo(
            model_config, train_config, hpo_config, train_ds, valid_ds,
            device=device, mesh=mesh, **seams(0, model_config),
        )
    groups: list[tuple[ModelConfig, dict[str, Any]]] = []
    for spec in hpo_config.architectures:
        cfg = parse_architecture_spec(spec, model_config)
        overridden = {
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ModelConfig)
            if getattr(cfg, f.name) != getattr(model_config, f.name)
        }
        groups.append((cfg, {"family": cfg.family, **overridden}))

    results: list[HPOResult] = []
    merged_trials: list[dict[str, Any]] = []
    for g, (cfg, structural) in enumerate(groups):
        group_hpo = dataclasses.replace(hpo_config, seed=hpo_config.seed + g)
        fingerprint = _group_fingerprint(cfg, group_hpo, train_config, train_ds)
        res = (
            _load_group_result(resume_dir, g, fingerprint, cfg)
            if resume_dir is not None
            else None
        )
        if res is None:
            res = run_hpo(
                cfg, train_config, group_hpo, train_ds, valid_ds, device=device,
                mesh=mesh, **seams(g, cfg),
            )
            if resume_dir is not None and is_coordinator():
                _save_group_result(resume_dir, g, fingerprint, res)
        results.append(res)
        for trial in res.trials:
            merged_trials.append({"group": g, "architecture": structural, **trial})

    def objective_of(res: HPOResult) -> float:
        v = res.best_metrics[f"validation_{hpo_config.objective}_score"]
        return v if np.isfinite(v) else -np.inf

    best_group = int(np.argmax([objective_of(r) for r in results]))
    winner = results[best_group]
    win_cfg, win_structural = groups[best_group]
    offset = sum(len(r.trials) for r in results[:best_group])
    surfaced = {
        k: ("x".join(map(str, v)) if isinstance(v, tuple) else v)
        for k, v in win_structural.items()
    }
    return win_cfg, HPOResult(
        best_index=offset + winner.best_index,
        best_hyperparams={**surfaced, **winner.best_hyperparams},
        best_params=winner.best_params,
        best_metrics=winner.best_metrics,
        trials=merged_trials,
    )
