"""Carry model and serving state across from the JAX package.

The tests feed both packages identical state: they take the JAX package's
quant params and the quant student's f32 master, monitor arrays and flax
param trees (the exact tier's model and the distilled bulk student) and
the gbm tier's tree arrays as numpy (``np.asarray`` of its leaves, or the arrays its npz files hold)
and hand them to these functions, which return the port's tensors on
``device``. bf16 leaves
arrive either as the f32 image the npz holds or as an ml_dtypes bfloat16
array; both map to the same bf16 bits.

A flax param tree is nested dicts keyed by module and parameter name; the
port's modules carry the same names, so the tree flattened with ``.`` is
a ``state_dict`` (``flatten_tree`` / ``unflatten_tree``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from mlops_tpu_torch.monitor.state import MonitorState
from mlops_tpu_torch.ops.quant import quant_params_from_arrays

_QUANT_KEYS = {"embed", "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2"}
_MASTER_KEYS = {"embed", "w1", "b1", "w2", "b2"}


def quant_params_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """Quant param arrays -> the port's dict of tensors on ``device``."""
    if set(arrays) != _QUANT_KEYS:
        raise KeyError(
            f"quant params must hold {sorted(_QUANT_KEYS)}, got {sorted(arrays)}"
        )
    # bf16 embed: widening to f32 is exact, and quant_params_from_arrays
    # narrows it back to the same bits.
    host = {
        k: np.asarray(v, np.float32) if k == "embed" else np.asarray(v)
        for k, v in arrays.items()
    }
    return {k: v.to(device) for k, v in quant_params_from_arrays(host).items()}


def quant_master_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """The quant student's f32 master (``init_quant_master``'s keys) ->
    f32 tensors on ``device``."""
    if set(arrays) != _MASTER_KEYS:
        raise KeyError(
            f"a quant master must hold {sorted(_MASTER_KEYS)}, got {sorted(arrays)}"
        )
    return {
        k: torch.from_numpy(np.array(v, np.float32, copy=True)).to(device)
        for k, v in arrays.items()
    }


def monitor_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> MonitorState:
    """Monitor arrays (``MonitorState.to_arrays`` of either package) -> the
    port's ``MonitorState`` on ``device``."""
    return MonitorState.from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}
    ).to(device)


def gbm_variables_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """``extract_gbm``'s tree arrays (either package's, or the tree file's)
    -> the gbm tier's tensors on ``device``: f64 values, thresholds and
    baseline, int64 indices, bool flags and table (``GBM_FIELDS``)."""
    from mlops_tpu_torch.ops.gbm_tensor import GBM_FIELDS

    if set(arrays) != set(GBM_FIELDS):
        raise KeyError(
            f"gbm trees must hold {sorted(GBM_FIELDS)}, got {sorted(arrays)}"
        )
    return {
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device=device, dtype=dtype)
        for k, dtype in GBM_FIELDS.items()
    }


def flatten_tree(tree: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dicts -> ``{"a.b.c": leaf}``."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_tree(value, name + "."))
        else:
            flat[name] = value
    return flat


def unflatten_tree(flat: dict[str, Any]) -> dict[str, Any]:
    """``{"a.b.c": leaf}`` -> nested dicts with keys sorted at every level,
    the order of a flax param tree."""
    tree: dict[str, Any] = {}
    for name in sorted(flat):
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = flat[name]
    return tree


def _to_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def doc_params_from_numpy(
    tree: dict[str, Any], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """A flax doc-model param tree (numpy or tensor leaves) -> the port's
    ``state_dict`` entries on ``device``, ready for ``load_params``."""
    return {k: _to_tensor(v).to(device) for k, v in flatten_tree(tree).items()}


def exact_params_from_numpy(
    tree: dict[str, Any], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """A flax exact-tier param tree (``linear``, ``mlp``, or a
    ``DeepEnsemble`` whose ``member`` subtree carries the vmapped ``[K,
    ...]`` axis; the variables ``{"params": ...}`` or the params alone) ->
    the port's ``state_dict`` entries on ``device``, ready for
    ``load_params`` into ``models.build_model``'s module. The member axis
    maps onto the port's stacked parameters as it is."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return doc_params_from_numpy(tree, device)


def pp_params_from_numpy(
    tree: dict[str, Any], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """The JAX package's stage layout (``split_trunk_params``'s ``{"embed":
    ..., "stages": [S, L, ...] blocks, "head": ...}``) -> the port's
    ``PipelineModel`` names (``embed.*``, ``stages.*``, ``head.*``), whole
    (every stage) on ``device``; ``parallel.sharding.shard_tensor`` takes
    a rank's ``[1, L, ...]`` block of ``stages.*``."""
    if set(tree) != {"embed", "stages", "head"}:
        raise KeyError(f"a stage layout holds embed, stages and head, got {sorted(tree)}")
    return doc_params_from_numpy(tree, device)


def bulk_student_from_numpy(
    config: Any, tree: dict[str, Any], device: torch.device | str
) -> nn.Module:
    """A distilled bulk student (its ``ModelConfig`` from the manifest's
    ``bulk`` block and its flax param tree) -> the port's module on
    ``device``, in eval."""
    from mlops_tpu_torch.models import build_model

    model = build_model(config)
    return load_params(model, exact_params_from_numpy(tree, "cpu")).to(device).eval()


@torch.no_grad()
def load_params(model: nn.Module, params: dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``params`` (flattened names) into ``model``'s f32 parameters.
    Raises ``ValueError`` naming every missing, unexpected or misshapen
    entry instead of loading a tree that does not match."""
    want = model.state_dict()
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    shapes = sorted(
        f"{k}: {tuple(params[k].shape)} != {tuple(want[k].shape)}"
        for k in set(want) & set(params)
        if tuple(params[k].shape) != tuple(want[k].shape)
    )
    if missing or extra or shapes:
        raise ValueError(
            "param tree does not match the module: "
            f"missing {missing}, unexpected {extra}, shapes {shapes}"
        )
    for name, tensor in want.items():
        tensor.copy_(params[name])
    return model
