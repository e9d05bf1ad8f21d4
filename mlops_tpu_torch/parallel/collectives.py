"""Collectives over a mesh axis, differentiable where a trainer needs them.

The JAX package gets its collectives from XLA (pjit) or writes them with
``shard_map`` (``psum``, ``all_gather``, ``ppermute``); here each is an
autograd ``Function`` over the axis's process group, with the backward
its transpose takes under the layouts of this package, where a value is
either replicated over the axis (every rank holds the same, and its
consumers compute the same) or sharded (each rank holds its piece):

- ``reduce_from``: partial sums -> their sum, replicated (the row-split
  matmul's all-reduce); backward the identity;
- ``copy_to``: a replicated value entering sharded work; forward the
  identity, backward the all-reduce of the partial gradients;
- ``take_shard``: this rank's slice of a replicated value; backward
  gathers the slices' gradients (the gradient stays replicated);
- ``gather``: shards -> the whole, replicated; backward takes this rank's
  slice;
- ``pmean``: the mean over the axis, one value replicated; backward the
  gradient over the axis size (each rank's share of the one value);
  with ``terms=True`` the mean enters every rank's own loss term (a
  data-parallel trainer's per-rank losses, their gradients meaned after
  the backward), and the backward is the mean of every rank's gradient;
- ``ring_shift``: ``ppermute`` by +1 around the axis; backward sends the
  gradient the other way (by -1), the inverse permutation.

Reductions of bf16 and f16 values run in f32 and round once. Every one
runs on gloo (CPU tensors) and NCCL (card tensors) alike; on an axis of
size 1 each is still one call of the backend (a copy).

``COLLECTIVE_CALLS`` counts the all-reduces and all-gathers this process
hands its backend. It is a kernel wrapper's launch counter: a call made
while the stream is captured into a CUDA graph counts with the graph,
and every replay of that graph adds it (``serve/graphs.py``), so on a
sharded serving engine it counts the NCCL calls its replays make.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mlops_tpu_torch.ops.cuda_build import LaunchCounter
from mlops_tpu_torch.parallel.mesh import Mesh

COLLECTIVE_CALLS = LaunchCounter("nccl_collective")


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (no autograd), in f32 for half types."""
    y = _wide(x).contiguous()
    dist.all_reduce(y, group=group)
    COLLECTIVE_CALLS.add()
    return y.to(x.dtype)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim`` in rank
    order (no autograd)."""
    n = dist.get_world_size(group)
    pieces = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(pieces, x.contiguous(), group=group)
    COLLECTIVE_CALLS.add()
    return torch.cat(pieces, dim=dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group).contiguous(), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, terms):
        ctx.group, ctx.terms = group, terms
        return all_reduce_sum(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        if ctx.terms:
            grad = all_reduce_sum(grad, ctx.group)
        return grad / n, None, None


def _shift(x: torch.Tensor, ranks: list[int], group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on along the axis and return
    what the rank ``step`` places back sent."""
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, ranks[(i + step) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(i - step) % n], group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, group):
        ctx.ranks, ctx.group = ranks, group
        return _shift(x, ranks, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.ranks, ctx.group, -1), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def take_shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _TakeShard.apply(x, dim % x.dim(), group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim % x.dim(), group)


def pmean(x: torch.Tensor, group, terms: bool = False) -> torch.Tensor:
    return _PMean.apply(x, group, terms)


def ring_shift_on(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``ppermute`` by +1 along ``axis`` (rank i's value lands on rank
    i + 1, cyclically); the identity on an axis of one rank."""
    ranks = mesh.axis_ranks[axis]
    if len(ranks) == 1:
        return x
    return _RingShift.apply(x, ranks, mesh.group(axis))
