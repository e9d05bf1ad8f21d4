"""Tensor-parallel training as a product configuration (the JAX
package's ``train/tensor_parallel.py``).

``model.tensor_parallel = K`` trains the dense family under the DP x TP
step of ``parallel/steps.py`` on a ``('data', 'model')`` mesh of the
world's ranks with a 'model' axis of K: ``train`` dispatches here through
``run_layout_training``, checkpoints resume onto the layout, and the
params gather back into the plain dense tree, so the bundle serves
through the ordinary exact tier. The model is the dense family's (TP is
a layout, not another network); at world size 1 the step is the dense
trainer's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mlops_tpu_torch.config import Config
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.parallel.distributed import initialize, rank_device
from mlops_tpu_torch.parallel.mesh import Mesh, make_mesh
from mlops_tpu_torch.parallel.steps import ShardedTrainStep, make_sharded_train_step
from mlops_tpu_torch.weights import load_params

# Families with param trees the PARAM_RULES lay out (gbm/rf are the
# host tree baselines, with no param tree to shard).
TP_FAMILIES = ("mlp", "linear", "ft_transformer", "bert", "moe")


@dataclasses.dataclass
class TPTrainer:
    """The dense module (for evaluation and packaging: whole params load
    into it), the laid-out step of this rank and the mesh."""

    model: nn.Module
    step: ShardedTrainStep
    mesh: Mesh


def make_tp_trainer(
    config: Config,
    mesh: Mesh | None = None,
    init_state: dict[str, torch.Tensor] | None = None,
    device: str | torch.device | None = None,
) -> TPTrainer:
    """The DP x TP trainer of a ``model.tensor_parallel=K`` config on this
    rank's device (``train.device`` when None: the card unless "cpu").

    The mesh defaults to ``('data', 'model')`` over the whole world with
    the 'model' axis sized K (the world joined here when it is not yet).
    The params start from the dense init of ``train.seed`` or from
    ``init_state`` (whole, by name: a pretrained graft), and are laid out
    over the mesh."""
    mcfg = config.model
    k = mcfg.tensor_parallel
    if k < 1:
        # The JAX package asks for >= 2; one card can hold only a 1-way
        # 'model' axis, the layout the card checks the step on.
        raise ValueError(f"make_tp_trainer needs model.tensor_parallel >= 1, got {k}")
    if mcfg.family not in TP_FAMILIES:
        raise ValueError(
            f"tensor_parallel applies to the Flax families {TP_FAMILIES}, "
            f"not {mcfg.family!r}"
        )
    dev = rank_device(device if device is not None else config.train.device)
    if mesh is None:
        n_dev = initialize(dev).size
        if n_dev % k:
            raise ValueError(
                f"model.tensor_parallel={k} needs the device count to be a "
                f"multiple of it; have {n_dev} (launch a multiple of {k} "
                "ranks: python -m torch.distributed.run --nproc-per-node N)"
            )
        mesh = make_mesh(n_dev, model_parallel=k)
    elif mesh.shape.get("model", 1) != k:
        raise ValueError(
            f"config tensor_parallel={k} != mesh 'model' axis "
            f"{mesh.shape.get('model', 1)}"
        )
    dp = mesh.shape.get("data", 1)
    if config.train.batch_size % dp:
        raise ValueError(
            f"train.batch_size={config.train.batch_size} must divide by "
            f"the mesh 'data' axis {dp} (devices / tensor_parallel)"
        )
    dense_cfg = dataclasses.replace(mcfg, tensor_parallel=0)
    whole = build_model(dense_cfg)
    if init_state is None:
        whole = init_params(whole, config.train.seed)
    else:
        whole = load_params(whole, init_state)
    step = make_sharded_train_step(whole, config.train, mesh, dev)
    return TPTrainer(model=build_model(dense_cfg).to(dev), step=step, mesh=mesh)
