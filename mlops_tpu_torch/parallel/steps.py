"""The DP x TP train step (the JAX package's ``parallel/steps.py``; its
data-parallel batch scorer is the bulk path's ``ChunkScorer`` on a data
mesh, ``parallel/bulk.py``).

The JAX package annotates shardings on one jitted step and lets XLA
insert the collectives. Here every rank runs the step on its block, and
the collectives are written where the Megatron layout of
``PARAM_RULES`` puts them:

- ``shard_model`` keeps this rank's block of every parameter split over
  'model' and sets the layers' ``tp``: ``dense_Na`` / ``Dense_0`` are
  column-split (output features; the input enters through ``copy_to``,
  whose backward all-reduces), ``dense_Nb`` / ``Dense_1`` and attention's
  ``out`` are row-split (the product all-reduced over 'model' before the
  bias), ``qkv`` runs this rank's heads, a mixture of experts runs its
  experts (the router and the auxiliary replicated, the combine
  all-reduced). An axis that does not divide a dimension leaves that
  layer whole, as the rules' dropped axis does.
- The batch splits over 'data' (each rank takes its rows of the global
  batch); the gradients are meaned over 'data', then clipped by the
  global norm over the logical arrays (``ClippedAdamW``'s ``sharded``)
  and applied by AdamW; its moments and the EMA live beside each
  parameter's block.
- Dropout draws each mask whole from the step's generator and keeps the
  rank's block (``ShardedStream``), so K ranks apply the masks one rank
  applies; the MoE auxiliary's means run over the logical batch.

At world size 1 every split is whole and every collective a copy over a
group of one: the step is the dense trainer's (``train/loop.py``), bit
for bit.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from mlops_tpu_torch.config import TrainConfig
from mlops_tpu_torch.models.layers import Dense, MultiHeadSelfAttention, TPSplit
from mlops_tpu_torch.models.moe import MoEFeedForward
from mlops_tpu_torch.parallel.collectives import all_reduce_sum
from mlops_tpu_torch.parallel.mesh import Mesh
from mlops_tpu_torch.parallel.sharding import (
    Spec,
    gather_tensor,
    param_shardings,
    row_block,
    shard_tensor,
    sharded_axes,
)
from mlops_tpu_torch.train.loop import (
    ClippedAdamW,
    dropout_generator,
    training_loss,
    update_ema,
)

_EXPERTS = ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias")


class ShardedStream:
    """One step's dropout stream on one rank of a layout: every mask is
    drawn whole (the logical activation: ``rows`` times the 'data' axis,
    ``split`` times the 'model' axis) from the step's generator, which
    every rank holds alike, and this rank's block of it is kept."""

    def __init__(self, generator: torch.Generator, mesh: Mesh) -> None:
        self.generator = generator
        self.dp, self.di = mesh.size("data"), mesh.index("data")
        self.tp, self.ti = mesh.size("model"), mesh.index("model")

    def uniform(
        self, shape, device: torch.device, rows: int = 0, split: int | None = None
    ) -> torch.Tensor:
        full = list(shape)
        full[rows] *= self.dp
        if split is not None:
            full[split] *= self.tp
        u = torch.rand(full, generator=self.generator, device=device)
        u = u.narrow(rows, self.di * shape[rows], shape[rows])
        if split is not None:
            u = u.narrow(split, self.ti * shape[split], shape[split])
        return u


def layout_specs(model: nn.Module, mesh: Any) -> dict[str, Spec]:
    """Each parameter's spec: ``param_shardings`` over the model's names,
    except that a mixture of experts keeps all four expert tensors on the
    expert axis whenever ``experts_in`` is split. (Cut from the right, the
    JAX rule puts an ensemble member's 3-d expert bias on its member axis;
    XLA lays that bias out anywhere at no cost to the arithmetic, while
    here the layers compute on the expert blocks.)"""
    specs = param_shardings(mesh, dict(model.named_parameters()))
    for name, mod in model.named_modules():
        if not isinstance(mod, MoEFeedForward):
            continue
        prefix = f"{name}." if name else ""
        lead = mod.experts_in.dim() - 3
        split = bool(sharded_axes(specs[prefix + "experts_in"]))
        for leaf in _EXPERTS:
            ndim = getattr(mod, leaf).dim()
            spec = [None] * ndim
            if split:
                spec[lead] = "model"
            specs[prefix + leaf] = tuple(spec)
    return specs


def shard_model(model: nn.Module, mesh: Mesh, specs: dict[str, Spec] | None = None):
    """Lay ``model`` (whole, on any device) out for this rank in place:
    its blocks of the split parameters, its layers' ``tp``, a mixture of
    experts' data group. Returns the specs."""
    specs = specs if specs is not None else layout_specs(model, mesh)
    tp = mesh.size("model")
    group = mesh.groups.get("model")
    index = mesh.index("model")
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, MoEFeedForward):
            mod.data_group = mesh.groups.get("data")
        if group is None:
            continue
        if isinstance(mod, Dense):
            axes = sharded_axes(specs[prefix + "kernel"])
            if not axes:
                continue
            ((dim, _),) = axes
            lead = len(mod.lead)
            n_out = mod.bias.dim() - lead
            n_in = mod.kernel.dim() - lead - n_out
            if dim - lead >= n_in:
                mod.tp = TPSplit("column", group, tp, index, lead + dim - lead - n_in)
            else:
                mod.tp = TPSplit("row", group, tp, index)
                mod.in_features //= tp
        elif isinstance(mod, MultiHeadSelfAttention):
            if sharded_axes(specs[prefix + "qkv.kernel"]):
                mod.heads //= tp
                mod.tp = TPSplit("heads", group, tp, index)
        elif isinstance(mod, MoEFeedForward):
            if sharded_axes(specs[prefix + "experts_in"]):
                mod.tp = TPSplit("experts", group, tp, index)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, specs[name], mesh)
    return specs


class ShardedTrainStep:
    """The laid-out model, its optimizer and EMA on this rank; ``step``
    runs one training step on the global batch. ``split_axis`` is the
    mesh axis the parameters are split over ('model' for TP, 'stage' for
    the pipeline), whose norms the clip completes."""

    def __init__(
        self,
        model: nn.Module,
        config: TrainConfig,
        mesh: Mesh,
        specs: dict[str, Spec],
        split_axis: str = "model",
    ) -> None:
        self.model = model
        self.config = config
        self.mesh = mesh
        self.specs = specs
        self.names = [name for name, _ in model.named_parameters()]
        self.data_group = mesh.groups.get("data")
        self.optimizer = ClippedAdamW(
            list(model.parameters()),
            config,
            sharded=[bool(sharded_axes(specs[n])) for n in self.names],
            group=mesh.groups.get(split_axis),
        )
        self.ema = (
            {k: torch.zeros_like(p) for k, p in model.named_parameters()}
            if config.ema_decay
            else None
        )

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: its contiguous
        block over 'data'."""
        return row_block(n, self.mesh)

    def backward(
        self, step: int, cat: torch.Tensor, num: torch.Tensor, lab: torch.Tensor
    ) -> torch.Tensor:
        """The loss of the global batch ``(cat, num, lab)`` (this rank takes
        its rows) with step ``step``'s dropout stream, and its gradients
        meaned over 'data' into the parameters' ``grad``; returns the
        logical batch's loss, detached."""
        rows = self.local_rows(cat.shape[0])
        self.optimizer.zero_grad()
        stream = ShardedStream(dropout_generator(self.config.seed, step, self.device), self.mesh)
        loss = training_loss(
            self.model, cat[rows], num[rows], lab[rows], stream, self.config.pos_weight
        )
        loss.backward()
        self.sync_grads()
        return self.data_mean(loss.detach())

    def step(
        self, step: int, cat: torch.Tensor, num: torch.Tensor, lab: torch.Tensor
    ) -> torch.Tensor:
        """One step on the global batch: ``backward``, the clipped AdamW
        update, the EMA. Returns the logical batch's loss, detached."""
        loss = self.backward(step, cat, num, lab)
        self.optimizer.step()
        if self.ema is not None:
            update_ema(self.ema, self.params(), self.config.ema_decay)
        return loss

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_group is None:
            return x
        return all_reduce_sum(x, self.data_group) / self.mesh.size("data")

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Every gradient meaned over 'data' (one all-reduce per leaf)."""
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.copy_(self.data_mean(p.grad))

    def gather(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Whole tensors (on every rank) from this rank's blocks of a
        per-parameter mapping (params, the EMA, a debiased EMA)."""
        return {
            name: gather_tensor(t.detach(), self.specs[name], self.mesh)
            for name, t in tensors.items()
        }

    def full_state(self) -> dict[str, Any]:
        """The whole training state, the dense trainer's checkpoint
        layout (``checkpoint.train_state``): a checkpoint of any layout
        resumes on any other."""
        opt = self.optimizer.state_dict()
        adam = opt["adamw"]
        state = {}
        for i, name in enumerate(self.names):
            entry = dict(adam["state"].get(i, {}))
            for key in ("exp_avg", "exp_avg_sq"):
                if key in entry:
                    entry[key] = gather_tensor(entry[key], self.specs[name], self.mesh)
            state[i] = entry
        full = {
            "model": self.gather(self.params()),
            "optimizer": {
                "adamw": {"state": state, "param_groups": adam["param_groups"]},
                "count": opt["count"],
            },
        }
        if self.ema is not None:
            full["ema"] = self.gather(self.ema)
        return full

    @torch.no_grad()
    def load_full_state(self, state: dict[str, Any]) -> None:
        """Take this rank's blocks of a whole checkpointed state; raises
        when it does not fit the model or the EMA setting."""
        got = state["model"]
        if set(got) != set(self.names):
            raise ValueError("the model state does not fit this model")
        if (state.get("ema") is None) != (self.ema is None):
            raise ValueError("train.ema_decay was toggled between runs")
        params = self.params()
        for name in self.names:
            local = shard_tensor(got[name], self.specs[name], self.mesh)
            if local.shape != params[name].shape:
                raise ValueError("the model state does not fit this model")
            params[name].copy_(local)
        adam = state["optimizer"]["adamw"]
        local_state = {}
        for i, name in enumerate(self.names):
            entry = dict(adam["state"].get(i, {}))
            for key in ("exp_avg", "exp_avg_sq"):
                if key in entry:
                    entry[key] = shard_tensor(entry[key], self.specs[name], self.mesh)
            local_state[i] = entry
        self.optimizer.load_state_dict({
            "adamw": {"state": local_state, "param_groups": adam["param_groups"]},
            "count": state["optimizer"]["count"],
        })
        if self.ema is not None:
            for name, e in self.ema.items():
                e.copy_(shard_tensor(state["ema"][name], self.specs[name], self.mesh))


def make_sharded_train_step(
    model: nn.Module,
    config: TrainConfig,
    mesh: Mesh,
    device: torch.device,
) -> ShardedTrainStep:
    """Lay ``model`` (whole and initialized, on the CPU) out over ``mesh``
    for this rank, move it to ``device`` and build its step."""
    specs = shard_model(model, mesh)
    model.to(device)
    return ShardedTrainStep(model, config, mesh, specs)
