"""Sharding specs: the batch layout and regex partition rules over the
port's parameter names (the JAX package's ``parallel/sharding.py``).

Megatron-style tensor parallelism: the first matmul of each block is
column-split (output features over 'model'), the second row-split (input
features over 'model'), with an all-reduce on the row cut's output;
attention splits by heads, and a mixture of experts by experts.
Embeddings, norms and biases replicate. A spec is a tuple with one mesh
axis name (or None) per dimension of the parameter, the JAX
``PartitionSpec``'s entries; ``()`` replicates.

The rules are the JAX package's with its ``/`` path separator as the
port's ``.`` (``weights.flatten_tree``: a flax path ``a/b/c`` is the
``state_dict`` name ``a.b.c``), and ``param_shardings`` keeps its
semantics: the first rule that matches wins, the default replicates,
extra leading axes (an ensemble's members, a sweep's trials) replicate,
a spec is cut to the parameter's rank from the right, and an axis that
does not divide its dimension is dropped. The serving-side helpers of
the JAX module (``serve_mesh``, ``sharded_avals``, ``replicated_avals``)
belong to ``serve.model_shards``, ROADMAP A11b.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from mlops_tpu_torch.parallel.collectives import all_gather_cat

Spec = tuple

# (name regex, spec): first match wins; default replicate.
PARAM_RULES: tuple[tuple[str, Spec], ...] = (
    # MLP residual blocks: a = column-parallel, b = row-parallel.
    (r"dense_\d+a\.kernel", (None, "model")),
    (r"dense_\d+b\.kernel", ("model", None)),
    (r"stem\.kernel", (None, None)),
    # Attention (qkv kernel [embed, 3, heads, head_dim], out kernel
    # [heads, head_dim, embed]): the heads axis.
    (r"Attention_\d+\.qkv\.kernel", (None, None, "model", None)),
    (r"Attention_\d+\.out\.kernel", ("model", None, None)),
    # FT-Transformer FFN: Dense_0 widens (column), Dense_1 narrows (row).
    (r"block_\d+\.Dense_0\.kernel", (None, "model")),
    (r"block_\d+\.Dense_1\.kernel", ("model", None)),
    # MoE: stacked expert weights [E, ...], E/ep experts per rank (the
    # spec cut from the right for the 2-d biases).
    (r"experts_", ("model", None, None)),
)


def _sizes(mesh: Any) -> dict[str, int]:
    """Axis sizes of a ``Mesh`` or of a plain ``{axis: size}`` dict."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def spec_for(
    name: str,
    shape: tuple[int, ...],
    mesh: Any,
    rules: tuple[tuple[str, Spec], ...] = PARAM_RULES,
) -> Spec:
    """The spec of one parameter by name and shape (the JAX ``assign``)."""
    sizes = _sizes(mesh)
    ndim = len(shape)
    for pattern, spec in rules:
        if re.search(pattern, name):
            if ndim > len(spec):
                # Extra LEADING axes replicate; the rule stays aligned to
                # the kernel's own trailing dims.
                spec = (None,) * (ndim - len(spec)) + tuple(spec)
            trimmed = tuple(spec[:ndim])
            return tuple(
                None if axis is not None and dim % sizes.get(axis, 1) else axis
                for dim, axis in zip(shape, trimmed)
            )
    return ()


def param_shardings(
    mesh: Any,
    params: dict[str, Any],
    rules: tuple[tuple[str, Spec], ...] = PARAM_RULES,
) -> dict[str, Spec]:
    """``{name: spec}`` for a ``state_dict``-style mapping of parameters
    (tensors or arrays; only their shapes are read)."""
    return {
        name: spec_for(name, tuple(p.shape), mesh, rules) for name, p in params.items()
    }


def batch_sharding(mesh: Any = None, ndim: int = 2) -> Spec:
    """The leading (batch) axis over 'data', trailing axes replicated."""
    return ("data",) + (None,) * (ndim - 1)


def row_block(rows: int, mesh: Any = None) -> slice:
    """This rank's rows of ``rows`` under ``batch_sharding``: its contiguous
    block over 'data' (``rows`` must divide by the axis); every row
    without a mesh."""
    if mesh is None:
        return slice(0, rows)
    n, i = mesh.size("data"), mesh.index("data")
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over 'data' axis {n}")
    b = rows // n
    return slice(i * b, (i + 1) * b)


def replicated(mesh: Any = None) -> Spec:
    return ()


def sharded_axes(spec: Spec) -> list[tuple[int, str]]:
    """(dimension, mesh axis) of every split dimension of ``spec``."""
    return [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]


def shard_tensor(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a contiguous copy;
    ``full`` itself when replicated)."""
    out = full
    for dim, axis in sharded_axes(spec):
        n = mesh.size(axis)
        size = full.shape[dim] // n
        out = out.narrow(dim, mesh.index(axis) * size, size)
    return out.contiguous() if out is not full else full


def gather_tensor(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (the
    inverse of ``shard_tensor``; collective over the spec's axes), a new
    tensor either way."""
    axes = sharded_axes(spec)
    if not axes:
        return local.clone()
    out = local
    for dim, axis in reversed(axes):
        out = all_gather_cat(out, dim, mesh.group(axis))
    return out
