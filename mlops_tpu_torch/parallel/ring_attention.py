"""Ring attention: exact sequence-parallel attention over a mesh axis (the
JAX package's ``parallel/ring_attention.py``).

Each rank of the ring holds a ``[B, S/n, H, D]`` block of Q, K and V. The
K/V blocks travel around the axis (``ring_shift``: one send to the next
rank, one receive from the previous) while every rank folds the visiting
block into an online-softmax accumulator for its local queries: the local
block first, then exactly ``n - 1`` hops, with no final rotation. After
them each query has attended over the whole sequence, and no rank ever
holds the whole K/V or an ``S x S`` score matrix: one ``[B, H, S/n,
S/n]`` score tile per hop.

The fold is the JAX package's, in plain PyTorch as its is ``jnp``: the
scores ``einsum(q, k)`` in f32 times the scale, the running max ``m``,
the running sum ``l`` and the f32 accumulator rescaled by ``exp(m -
m_new)``, ``p`` cast to v's type for ``einsum(p, v)``. The hops are
differentiable (``ring_shift``'s backward sends the gradient the other
way), so autograd gives the backward. Attention is bidirectional, as the
consumers (BERT-style encoders) are.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from mlops_tpu_torch.parallel.collectives import ring_shift_on
from mlops_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def ring_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str,
    scale: float | None = None,
) -> torch.Tensor:
    """This rank's part: local blocks ``[B, S_local, H, D]`` of q, k and v
    in, the local output block ``[B, S_local, H, D]`` out."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    b, s_q, h, _ = q.shape
    n = mesh.size(axis_name)

    def fold(carry, k_cur, v_cur):
        m, l, acc = carry
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_cur).float() * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cur.dtype), v_cur).float()
        return m_new, l_new, acc * alpha.movedim(1, 2) + pv

    m0 = torch.full((b, h, s_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l0 = torch.zeros((b, h, s_q, 1), dtype=torch.float32, device=q.device)
    acc0 = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    carry = fold((m0, l0, acc0), k, v)
    k_cur, v_cur = k, v
    for _ in range(n - 1):
        k_cur = ring_shift_on(k_cur, mesh, axis_name)
        v_cur = ring_shift_on(v_cur, mesh, axis_name)
        carry = fold(carry, k_cur, v_cur)
    _, l, acc = carry
    return (acc / l.movedim(1, 2)).to(q.dtype)


def make_ring_attention(
    mesh: Mesh,
    seq_axis: str = "seq",
    scale: float | None = None,
) -> Callable:
    """``fn(q, k, v) -> out`` over this rank's blocks ``[B, S/n, H, D]``.

    The hops run on ``seq_axis`` only. Under DP x SP a rank passes its data
    block of the B rows, and each data index runs its own ring; heads are
    independent, so a rank holding a block of the heads passes that block.
    S must divide by the seq axis."""

    def ring(q, k, v):
        return ring_attention_shard(q, k, v, mesh=mesh, axis_name=seq_axis, scale=scale)

    return ring
