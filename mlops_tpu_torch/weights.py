"""Carry model and serving state across from the JAX package.

The tests feed both packages identical state: they take the JAX package's
quant params, monitor arrays and flax param trees as numpy (``np.asarray``
of its leaves, or the arrays its npz files hold) and hand them to these
functions, which return the port's tensors on ``device``. bf16 leaves
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


def monitor_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> MonitorState:
    """Monitor arrays (``MonitorState.to_arrays`` of either package) -> the
    port's ``MonitorState`` on ``device``."""
    return MonitorState.from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}
    ).to(device)


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
