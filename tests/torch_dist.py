"""Spawn helper of the multi-rank tests (``test_torch_parallel.py``,
``test_torch_tensor_parallel.py``, ``test_torch_pipeline_parallel.py``,
``test_torch_seq_parallel.py``): a group of gloo ranks of the port on the
CPU, one process each, that runs named jobs of ``torch_dist_jobs.py``.

``run_group(world, jobs, inputs, workdir)`` writes ``inputs`` (numpy
arrays and plain values) beside the jobs' names, starts ``world``
processes (``python tests/torch_dist.py <workdir>`` with ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set, so each joins
through the port's own ``parallel.distributed.initialize``), and returns
rank 0's results, one per job. The children import torch and the port,
never JAX: the test process compares their results with the JAX package.

Every group has a deadline (``DEADLINE_S``): the rendezvous and every
collective time out inside it (``initialize(timeout_s=...)``), the
parent waits for the children no longer than it, and kills them all on
expiry, so a hung rendezvous fails its test instead of holding the
suite.
"""

from __future__ import annotations

import io
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 240
COLLECTIVE_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_group(world: int, jobs: list[str], inputs: dict, workdir: Path,
              deadline_s: float = DEADLINE_S) -> dict:
    """Run ``jobs`` (names in ``torch_dist_jobs.JOBS``) on ``world`` gloo
    ranks; rank 0's ``{job: result}``. A rendezvous port another process
    took between its pick and its bind is picked again, once."""
    try:
        return _run_group(world, jobs, inputs, Path(workdir), deadline_s)
    except _PortTaken:
        return _run_group(world, jobs, inputs, Path(workdir), deadline_s)


class _PortTaken(RuntimeError):
    pass


def _run_group(world: int, jobs: list[str], inputs: dict, workdir: Path,
               deadline_s: float) -> dict:
    import torch

    workdir.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save({"jobs": jobs, "inputs": inputs}, buf)
    (workdir / "inputs.pt").write_bytes(buf.getvalue())
    port = _free_port()
    procs = []
    files = []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        files.append(log)
        env = dict(
            os.environ,
            PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
            RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            OMP_NUM_THREADS="1",
        )
        env.pop("MLOPS_TPU_COORDINATOR", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(workdir)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    end = time.monotonic() + deadline_s
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in files:
            log.close()
    codes = [proc.returncode for proc in procs]
    if codes != [0] * world:
        logs = [(workdir / f"rank{r}.log").read_text() for r in range(world)]
        tails = "\n".join(
            f"--- rank {r} (exit {c}) ---\n{log[-3000:]}"
            for r, (c, log) in enumerate(zip(codes, logs))
        )
        message = f"the {world}-rank group failed or passed its deadline:\n{tails}"
        if "EADDRINUSE" in logs[0] or "address already in use" in logs[0]:
            raise _PortTaken(message)
        raise RuntimeError(message)
    return torch.load(io.BytesIO((workdir / "results.pt").read_bytes()), weights_only=False)


def _child(workdir: Path) -> int:
    import torch

    torch.set_num_threads(1)
    import torch_dist_jobs
    from mlops_tpu_torch.parallel.distributed import initialize, shutdown

    spec = torch.load(io.BytesIO((workdir / "inputs.pt").read_bytes()), weights_only=False)
    world = initialize("cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    results = {}
    for name in spec["jobs"]:
        t0 = time.perf_counter()
        results[name] = torch_dist_jobs.JOBS[name](spec["inputs"], workdir)
        print(f"rank {world.rank}: {name} {time.perf_counter() - t0:.2f} s", flush=True)
    if world.rank == 0:
        buf = io.BytesIO()
        torch.save(results, buf)
        (workdir / "results.pt").write_bytes(buf.getvalue())
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_child(Path(sys.argv[1])))
