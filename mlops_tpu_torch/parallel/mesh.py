"""Meshes over ranks: the JAX package's ``parallel/mesh.py`` with one rank
per card in place of a device list.

A mesh names the axes of a grid of ranks, ``arange(world)`` reshaped in
C order (the last axis varies fastest, as in JAX: put the axis that
talks most last). Each rank of the grid knows its coordinate on every
axis and holds one process group per axis: the ranks that share its
other coordinates. Building a mesh is collective: every rank of the
world calls it with the same arguments (``torch.distributed.new_group``
needs them all), ranks outside ``ranks`` included, which then hold no
coordinates (``member`` is False). ``backend`` builds the axes' groups
over another backend than the world's (a gloo mesh for CPU tensors in a
process whose world runs NCCL).
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

AXES = ("data", "model")


class Mesh:
    """Named axes over a grid of ranks, with a process group per axis."""

    def __init__(
        self, axis_sizes: dict[str, int], ranks: list[int], backend: str | None = None
    ) -> None:
        self.axis_names = tuple(axis_sizes)
        self.shape = {k: int(v) for k, v in axis_sizes.items()}
        self.devices = np.asarray(ranks).reshape(tuple(self.shape.values()))
        me = dist.get_rank()
        self.member = bool((self.devices == me).any())
        self.coords: dict[str, int] = {}
        self.groups: dict[str, object] = {}
        self.axis_ranks: dict[str, list[int]] = {}
        if self.member:
            where = np.argwhere(self.devices == me)[0]
            self.coords = dict(zip(self.axis_names, map(int, where)))
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, self.shape[axis])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members, backend=backend)
                if me in members:
                    self.groups[axis] = group
                    self.axis_ranks[axis] = members

    def size(self, axis: str) -> int:
        """The axis's length (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]

    def describe(self) -> list[int]:
        """The grid's shape, as the JAX command prints ``mesh``."""
        return list(self.devices.shape)


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> tuple[int, int]:
    """Factor a rank count into (data, model) axis sizes."""
    if n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel="
            f"{model_parallel}"
        )
    return n_devices // model_parallel, model_parallel


def _world_ranks() -> list[int]:
    return list(range(dist.get_world_size()))


def make_nd_mesh(
    axis_sizes: dict[str, int], ranks: list[int] | None = None, backend: str | None = None
) -> Mesh:
    """A mesh with arbitrary named axes, e.g. ``{'data': 2, 'seq': 4}``
    (DP x sequence parallel) or ``{'data': 2, 'stage': 2}`` (DP x PP),
    over the first ``prod(sizes)`` of ``ranks`` (the world's when None)."""
    ranks = ranks if ranks is not None else _world_ranks()
    n = 1
    for size in axis_sizes.values():
        n *= size
    if n > len(ranks):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(ranks)}")
    return Mesh(dict(axis_sizes), list(ranks[:n]), backend)


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    ranks: list[int] | None = None,
) -> Mesh:
    """A ``('data', 'model')`` mesh over ``n_devices`` ranks (the world)."""
    ranks = ranks if ranks is not None else _world_ranks()
    n = n_devices or len(ranks)
    return make_nd_mesh(dict(zip(AXES, mesh_shape_for(n, model_parallel))), ranks)
