"""Sharded serving over S ranks (``serve.model_shards = S``): the follower
loop and the processes that run it.

One sharded engine is S ``torch.distributed`` ranks, one card each,
forming one ('model',) ``ServeMesh`` (``parallel/sharding.serve_mesh``).
Rank 0, the lead, is the serving process: it builds the engines, owns
dispatch and fetch, and announces every operation that runs the model's
collectives before it runs it (``InferenceEngine._tell``). Every other
rank, a follower, runs ``follow``: it builds its twin of each engine the
lead builds, from the bundle the lead sends, and runs each announced
operation on its own blocks in the lead's lock order, so the collectives
(on the card, the NCCL calls inside each CUDA graph) meet across ranks.
A follower needs nothing but its place in the group and the lead's
rendezvous port: no config, no bundle directory, no serving port.

``start_followers`` is the lead's side of a serving plane: it starts the
S - 1 follower processes (``python -m mlops_tpu_torch.serve.shards``),
joins the group as rank 0 through ``parallel/distributed.initialize``
and builds the mesh. A follower leaves when the lead stops the mesh or
when its parent process is gone (a ``kill -9`` of the lead); the lead
leaves (exit 70) when a follower dies, since a sharded engine cannot
answer without every rank, so the ring plane's supervisor respawns the
whole replica and the single-process plane exits.
"""

from __future__ import annotations

import datetime
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

FOLLOWER_EXIT = 70  # the lead's exit code when a follower rank died
_POLL_S = 0.5


def follow(mesh, device) -> dict:
    """A follower rank's loop: build each engine the lead announces (on
    ``device``, this rank's card or the CPU), run each announced
    operation, and drop each engine the lead dropped, until the lead stops
    the mesh. Returns the engines it holds then, by number."""
    from mlops_tpu_torch.serve.engine import InferenceEngine

    engines = {}
    while True:
        dropped, (op, sid, *args) = mesh.receive()
        for gone in dropped:
            engines.pop(gone, None)
        if op == "stop":
            return engines
        if op == "build":
            bundle, kwargs = args
            engines[sid] = InferenceEngine(bundle, device=device, mesh=mesh, **kwargs)
        elif op == "stage":
            candidate, seq = args
            engines[sid].follow_op(op, engines[candidate], seq)
        else:
            engines[sid].follow_op(op, *args)


def _store(rank: int, shards: int, port: int = 0) -> dist.TCPStore:
    """The group's rendezvous store: rank 0 serves it on a port the
    kernel picks (``port`` 0), the followers join it on that port."""
    from mlops_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S

    return dist.TCPStore("127.0.0.1", port, shards, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
                         wait_for_workers=False)


def _launch(store, rank: int, shards: int, offset: int) -> dict:
    return {"store": store, "rank": rank, "world_size": shards,
            "local_rank": offset + rank}

# tpulint Layer-3 manifest: the follower watch holds no lock (an event
# and a poll); a follower runs the lead's operations in the order the
# mesh lock (parallel/sharding.py ServeMesh.lock) gave them.
TPULINT_LOCK_ORDER: dict[str, tuple[str, ...]] = {"Followers": ()}


class Followers:
    """The follower processes of one sharded engine, watched from the
    lead: a follower's exit ends the lead (``FOLLOWER_EXIT``)."""

    def __init__(self, procs: list[subprocess.Popen]) -> None:
        self.procs = procs
        self._stopping = threading.Event()
        self._watch = threading.Thread(target=self._watch_loop, daemon=True,
                                       name="mlops-tpu-torch-shard-watch")
        self._watch.start()

    def _watch_loop(self) -> None:
        while not self._stopping.wait(_POLL_S):
            for rank, proc in enumerate(self.procs, start=1):
                code = proc.poll()
                if code is not None and not self._stopping.is_set():
                    logger.error("sharded engine: follower rank %d (pid %d) exited %s; "
                                 "the engine cannot answer without it, exiting",
                                 rank, proc.pid, code)
                    os._exit(FOLLOWER_EXIT)

    def stop(self, mesh, timeout_s: float = 30.0) -> list[int | None]:
        """End the followers' loops and wait for them (kill after
        ``timeout_s``); their exit codes."""
        self._stopping.set()
        try:
            mesh.stop()
        except Exception:  # tpulint: disable=TPU201,TPU405 — a follower already gone: kill the rest below
            logger.warning("sharded engine: stopping the followers failed", exc_info=True)
        end = time.monotonic() + timeout_s
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        return [proc.returncode for proc in self.procs]


def start_followers(shards: int, device: str = "cuda", offset: int = 0):
    """From the serving process: start ranks 1..S-1 on cards ``offset + 1
    .. offset + S - 1`` (or on the CPU over gloo), join the group as rank
    0 on card ``offset`` and build the ('model',) mesh. Returns ``(mesh,
    followers, world)``; ``followers.stop(mesh)`` ends them."""
    from mlops_tpu_torch.parallel import distributed
    from mlops_tpu_torch.parallel.sharding import serve_mesh

    kind = torch.device(device).type
    # The port is bound before any follower is told it: no other socket
    # can take it in between.
    store = _store(0, shards)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    # A launcher's variables of this process's own launch (if any) are not
    # the followers'.
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MLOPS_TPU_COORDINATOR"):
        env.pop(key, None)
    procs = [
        subprocess.Popen([sys.executable, "-m", "mlops_tpu_torch.serve.shards",
                          str(store.port), str(rank), str(shards), str(offset), kind],
                         env=env)
        for rank in range(1, shards)
    ]
    try:
        world = distributed.initialize(kind, launch=_launch(store, 0, shards, offset))
        mesh = serve_mesh(shards, offset, kind)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    logger.info("sharded engine: rank 0 of %d on %s, followers %s", shards, world.device,
                [proc.pid for proc in procs])
    return mesh, Followers(procs), world


def _exit_with_parent() -> None:
    """Leave when the lead that started this process is gone."""
    parent = os.getppid()

    def watch() -> None:
        while True:
            time.sleep(_POLL_S)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True, name="mlops-tpu-torch-lead-watch").start()


def follower_main(argv: list[str]) -> int:
    """``python -m mlops_tpu_torch.serve.shards <port> <rank> <S> <offset>
    <cuda|cpu>``: one follower rank of a sharded engine, joining the
    lead's store on ``port``."""
    port, rank, shards, offset = (int(a) for a in argv[:4])
    kind = argv[4]
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    # A drain's signals are the lead's: a follower ends when the lead stops
    # the mesh (or is gone).
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    _exit_with_parent()
    from mlops_tpu_torch.parallel import distributed
    from mlops_tpu_torch.parallel.sharding import serve_mesh

    world = distributed.initialize(
        kind, launch=_launch(_store(rank, shards, port), rank, shards, offset))
    mesh = serve_mesh(shards, offset, kind)
    engines = follow(mesh, world.device)
    logger.info("sharded engine: follower rank %d on %s ran until the stop (%d engines "
                "live); exiting", rank, world.device, len(engines))
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(follower_main(sys.argv[1:]))
