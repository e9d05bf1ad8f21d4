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
does not divide its dimension is dropped.

The serving side (``serve.model_shards = S``): ``serve_mesh`` is the
('model',) mesh of one engine over S ranks, one card each, and the
group's control channel. Params are split by the rules above; the
batch, the temperature, the monitor and the accumulator are replicated
(the rule the JAX ``sharded_avals`` / ``replicated_avals`` pin on avals
for its AOT warmup, which the port, lowering nothing ahead of time,
does not need).
"""

from __future__ import annotations

import datetime
import queue
import re
import threading
from typing import Any

import torch
import torch.distributed as dist

from mlops_tpu_torch.parallel.collectives import all_gather_cat
from mlops_tpu_torch.parallel.mesh import Mesh

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


# ------------------------------------------------------------- serving
class MeshOutOfStep(RuntimeError):
    """The ranks of a mesh issued different numbers of collectives: the
    next ones would pair the wrong partial sums. The engine cannot serve
    again; its replica restarts (a follower exits, which ends the lead)."""

# tpulint Layer-3 manifest (analysis/concurrency.py, read from source):
# the mesh's ``lock`` orders every announced operation across the
# engines on the mesh (it is each engine's ``_acc_lock``); a leaf here.
TPULINT_LOCK_ORDER = {"ServeMesh": ("lock",)}


class ServeMesh(Mesh):
    """The ('model',) mesh of one sharded serving engine: ranks ``0..S-1``
    of the world, one card each, and what the engines on it share.

    Rank 0 is the lead: it owns dispatch and fetch, and every operation
    of an engine on the mesh that runs the model's collectives (a
    dispatch, a warm pass or capture, a hot swap, regrid or rollback, a
    monitor read) is announced to the other ranks, the followers, over
    ``control`` (a gloo group of the same ranks, whatever the model
    group's backend) before the lead runs it; each follower runs the same
    operation on its blocks (``serve/shards.py::follow``). ``lock``
    orders those operations across every engine on the mesh (it is each
    engine's accumulator lock), so the collectives, and on the card the
    graph replays holding them, run in one order on every rank.
    ``streams`` are the card streams the mesh's engines share.

    The mesh holds no engine: an engine takes the number ``built`` as its
    name on every rank, and when the lead's engine is collected its
    number goes to the followers with the next announcement (``dropped``),
    so a follower's twin lives as long as the lead's engine."""

    def __init__(self, shards: int) -> None:
        super().__init__({"model": shards}, list(range(shards)))
        # A follower waits on the control group for as long as the server
        # is idle: its timeout is not a collective's.
        self.control = (
            dist.new_group(list(range(shards)), backend="gloo",
                           timeout=datetime.timedelta(days=365))
            if shards > 1 else None
        )
        self.lock = threading.Lock()
        self.built = 0
        # Put from a finalizer, on whichever thread collects the engine.
        self.dropped: queue.SimpleQueue = queue.SimpleQueue()
        self.streams: tuple | None = None
        self.broken: str | None = None

    @property
    def lead(self) -> bool:
        return self.index("model") == 0

    @property
    def followers(self) -> int:
        return self.size("model") - 1

    def announce(self, message: tuple) -> None:
        """The lead's side of one operation: ``message``, with the numbers
        of the engines dropped since the last one, to every follower
        (caller holds ``lock``; nothing with no followers). Raises once
        the mesh is out of step."""
        if self.broken is not None:
            raise MeshOutOfStep(self.broken)
        if self.followers:
            dropped = []
            while not self.dropped.empty():
                dropped.append(self.dropped.get_nowait())
            dist.broadcast_object_list([(dropped, message)], src=0, group=self.control)

    def receive(self) -> tuple[list[int], tuple]:
        """A follower's side: the engines the lead dropped since its last
        message, and the message (blocks)."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def agree(self, ok: bool, issued: int) -> bool:
        """Every rank's outcome of one operation that may fail on some
        ranks only (readying a shape; caller holds ``lock``): whether it
        succeeded on all of them. ``issued`` is how many collectives this
        rank ran meanwhile; when the ranks differ, the mesh is out of step
        and this raises ``MeshOutOfStep`` on every rank."""
        if not self.followers:
            return ok
        votes = torch.tensor([int(not ok), issued, -issued], dtype=torch.int64)
        dist.all_reduce(votes, op=dist.ReduceOp.MAX, group=self.control)
        failed, most, least = votes[0].item(), votes[1].item(), -votes[2].item()
        if most != least:
            self.broken = (
                f"the mesh's ranks ran between {least} and {most} collectives "
                "readying one shape; the sharded engine must restart"
            )
            raise MeshOutOfStep(self.broken)
        return not failed

    def stop(self) -> None:
        """End the followers' loops (the lead, at shutdown)."""
        with self.lock:
            self.announce(("stop", -1))


def serve_mesh(shards: int, offset: int = 0, device: Any = "cuda") -> ServeMesh:
    """The ('model',)-only mesh of ``serve.model_shards = shards`` over the
    first ``shards`` ranks of this process's group (built collectively,
    every rank calling it alike): params split by ``PARAM_RULES``, the
    batch, the monitor and the accumulator replicated. Rank k drives card
    ``offset + k``; ``offset`` is how replica r of the ring plane takes
    its cards ``[r*S, (r+1)*S)``. On the card, raises as the JAX
    ``serve_mesh`` does when this process sees fewer than ``offset +
    shards`` cards."""
    if shards < 1:
        raise ValueError(f"serve.model_shards={shards} must be >= 1")
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if offset + shards > visible:
            raise ValueError(
                f"serve.model_shards={shards} at device offset {offset} "
                f"exceeds the {visible} visible devices in this engine "
                "process"
            )
    world = dist.get_world_size()
    if shards > world:
        raise ValueError(
            f"serve.model_shards={shards} needs {shards} ranks; this process's "
            f"group has {world}"
        )
    return ServeMesh(shards)
