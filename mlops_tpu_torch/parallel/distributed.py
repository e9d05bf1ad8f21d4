"""Multi-process bring-up: one rank per card under ``torch.distributed``.

The JAX package is one controller that sees every device; here each card
is driven by a process of its own, a rank. ``initialize`` joins this
process to its group, idempotently:

- under a launcher (``python -m torch.distributed.run --nproc-per-node N
  -m mlops_tpu_torch ...``) from its ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` and its rendezvous (``MASTER_ADDR`` / ``MASTER_PORT``);
- from the JAX package's own contract, ``MLOPS_TPU_COORDINATOR``
  (``host:port``) / ``MLOPS_TPU_PROCESS_ID`` / ``MLOPS_TPU_NUM_PROCESSES``,
  which fails fast when the coordinator is set with fewer than 2
  processes, as the JAX package does;
- otherwise as a world of one, from a store in this process;
- or from an explicit ``launch`` (``rank``, ``world_size``,
  ``local_rank`` and a rendezvous ``store``), which is how a sharded
  serving process starts its follower ranks (``serve/shards.py``)
  without putting a launcher's variables into its own environment.

The backend follows the device: NCCL when the rank's device is the card
(``cuda:LOCAL_RANK``), gloo when the caller asked for the CPU. Neither
stands in for the other: NCCL missing on a card, or a card asked for and
absent, raises. The world size takes the place of the JAX package's
device count wherever a mesh is sized.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os

import torch
import torch.distributed as dist

from mlops_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# How long a collective or a rendezvous may wait before it raises
# (torch's default is 30 minutes for gloo and 10 for NCCL).
DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the group: its rank, the world size, its
    local rank (the card index on its host), its device and the
    backend."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


_WORLD: World | None = None


def multihost_env() -> dict | None:
    """The launch this process belongs to, from the environment, or None
    for a single-process run.

    - ``MLOPS_TPU_COORDINATOR`` / ``MLOPS_TPU_PROCESS_ID`` /
      ``MLOPS_TPU_NUM_PROCESSES``: the JAX package's own contract (a K8s
      JobSet or an mpirun wrapper sets it); the coordinator is the
      rendezvous address ``host:port``;
    - ``RANK`` / ``WORLD_SIZE`` (``LOCAL_RANK``): a ``torch.distributed``
      launcher's, with its ``MASTER_ADDR`` / ``MASTER_PORT``.
    """
    env = os.environ
    if "MLOPS_TPU_COORDINATOR" in env:
        pid = int(env.get("MLOPS_TPU_PROCESS_ID", "0"))
        return {
            "init_method": f"tcp://{env['MLOPS_TPU_COORDINATOR']}",
            "rank": pid,
            "world_size": int(env.get("MLOPS_TPU_NUM_PROCESSES", "1")),
            "local_rank": int(env.get("LOCAL_RANK", "0")),
            "coordinator": True,
        }
    if "RANK" in env and "WORLD_SIZE" in env:
        return {
            "init_method": "env://",
            "rank": int(env["RANK"]),
            "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", "0")),
            "coordinator": False,
        }
    return None


def world_size() -> int:
    """Ranks in this launch: the group's size once joined, else what the
    environment announces (1 for a single-process run)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env = multihost_env()
    return env["world_size"] if env else 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = multihost_env()
    return env["rank"] if env else 0


def rank_device(
    device: str | torch.device | None = None, launch: dict | None = None
) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for the card (raising
    without one; ``launch``'s local rank when given), the CPU when asked
    for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    env = launch if launch is not None else multihost_env()
    local = env["local_rank"] if env else 0
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card: this host shows "
            f"{torch.cuda.device_count()} CUDA device(s)"
        )
    return torch.device("cuda", local)


def initialize(
    device: str | torch.device | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    launch: dict | None = None,
) -> World:
    """Join this process's group (idempotent) and return its ``World``.

    The device decides the backend: NCCL for the card, gloo for the CPU.
    A second call with another backend's device raises: one process runs
    one group. ``launch`` (``store``, ``rank``, ``world_size``,
    ``local_rank``) takes the place of the environment's launch."""
    global _WORLD
    dev = rank_device(device, launch)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if _WORLD is not None:
        if _WORLD.backend != backend:
            raise ValueError(
                f"this process joined its group over {_WORLD.backend}; a "
                f"{backend} group ({dev}) cannot be joined beside it"
            )
        return _WORLD
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "the card needs the NCCL backend, which this torch build lacks"
        )
    env = dict(launch, coordinator=False) if launch is not None else multihost_env()
    timeout = datetime.timedelta(seconds=timeout_s)
    if env is not None and env["coordinator"] and env["world_size"] <= 1:
        # A coordinator with <2 processes is an inconsistent launch
        # (MLOPS_TPU_NUM_PROCESSES forgotten): running each host alone
        # would train N divergent models, so fail fast.
        raise ValueError(
            "MLOPS_TPU_COORDINATOR is set but MLOPS_TPU_NUM_PROCESSES is "
            f"{env['world_size']}; a multi-host launch needs >= 2 "
            "(unset the coordinator for single-host runs)"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if env is None or "store" in env:
            store = dist.HashStore() if env is None else env["store"]
            dist.init_process_group(
                backend, store=store, rank=env["rank"] if env else 0,
                world_size=env["world_size"] if env else 1, timeout=timeout,
            )
        else:
            dist.init_process_group(
                backend,
                init_method=env["init_method"],
                rank=env["rank"],
                world_size=env["world_size"],
                timeout=timeout,
            )
        atexit.register(shutdown)
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the process group runs {dist.get_backend()}; {dev} needs {backend}"
        )
    _WORLD = World(
        rank=dist.get_rank(),
        size=dist.get_world_size(),
        local_rank=env["local_rank"] if env else 0,
        device=dev,
        backend=backend,
    )
    logger.info(
        "torch.distributed joined: rank %d/%d on %s over %s",
        _WORLD.rank, _WORLD.size, dev, backend,
    )
    return _WORLD


def shutdown() -> None:
    """Leave the group (the process exits right after, or a test starts
    another group)."""
    global _WORLD
    _WORLD = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """True on the process that writes run directories, bundles, registry
    entries and metrics files (rank 0; always in a single-process run)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank of the group (nothing outside a group or in a
    world of one)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` from rank ``src`` on every rank (itself outside a group)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
