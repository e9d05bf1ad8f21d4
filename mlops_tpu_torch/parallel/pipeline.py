"""Pipeline parallelism: GPipe microbatch streaming over a mesh axis (the
JAX package's ``parallel/pipeline.py``).

Stage-stacked layer weights ``[S, ...]`` split their leading axis over a
'stage' axis, one stage per rank. Microbatches stream through the ring:
at every tick each rank applies its stage to what it received, hands the
result to the next stage (``ring_shift``, one point-to-point send each
way), and stage ``S-1`` banks finished microbatches. ``M`` microbatches
drain in ``M + S - 1`` ticks, a bubble of ``(S-1)/(M+S-1)``.

As in the JAX scan, every rank runs every tick (a stage before its first
microbatch computes on zeros, whose result no stage banks) and picks its
input and banks its output with ``where`` on its stage index, so the
autograd graph has the same shape on every rank and the backward's sends
(the ring the other way) pair up tick for tick. The input enters through
``copy_to`` (only stage 0 reads it; its gradient is summed onto every
stage) and the banked outputs leave through ``reduce_from`` (every other
stage contributes zeros), so the stack is differentiable end to end.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree

from mlops_tpu_torch.parallel.collectives import copy_to, reduce_from, ring_shift_on
from mlops_tpu_torch.parallel.mesh import Mesh


def pipeline_stage_shard(
    stage_weights: Any,
    x: torch.Tensor,
    *,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    axis_name: str = "stage",
) -> torch.Tensor:
    """This rank's part of the pipeline.

    Args:
      stage_weights: this rank's stage, every leaf with its leading axis
        of 1 (its block of the ``[S, ...]`` stack).
      x: the microbatch stack ``[M, B, ...]``, the same on every stage
        (only stage 0 reads it).
      stage_fn: ``(weights of one stage, activation [B, ...]) -> [B, ...]``,
        the leaves without the stage axis.

    Returns the completed ``[M, B, ...]`` outputs, the same on every
    stage."""
    stages = mesh.size(axis_name)
    group = mesh.group(axis_name)
    s = mesh.index(axis_name)
    num_micro = x.shape[0]
    local = _pytree.tree_map(lambda w: w[0], stage_weights)
    x = copy_to(x, group)
    is_first = torch.tensor(s == 0, device=x.device)
    is_last = torch.tensor(s == stages - 1, device=x.device)
    zeros = torch.zeros_like(x[0])
    recv = zeros
    banked: list[torch.Tensor] = []
    ticks = num_micro + stages - 1
    for t in range(ticks):
        h = torch.where(is_first, x[min(t, num_micro - 1)], recv)
        y = stage_fn(local, h)
        if t >= stages - 1:  # microbatch t - (S-1) leaves the last stage
            banked.append(torch.where(is_last, y, zeros))
        if t < ticks - 1:
            recv = ring_shift_on(y, mesh, axis_name)
    return reduce_from(torch.stack(banked), group)


def make_pipeline(
    mesh: Mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    axis_name: str = "stage",
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """``run(stage_weights, x) -> y`` executing ``stage_fn`` as an S-deep
    pipeline over ``mesh[axis_name]``: ``stage_weights`` this rank's
    ``[1, ...]`` block of every stage-stacked leaf, ``x`` the microbatches
    ``[M, B, ...]``. Under DP x PP ``x`` is this rank's block of the B
    dimension and each data index runs its own ring. Equivalent to folding
    ``stage_fn`` over the stages in order."""

    def run(stage_weights: Any, x: torch.Tensor) -> torch.Tensor:
        return pipeline_stage_shard(
            stage_weights, x, stage_fn=stage_fn, mesh=mesh, axis_name=axis_name
        )

    return run
