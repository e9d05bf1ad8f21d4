"""Two NCCL ranks on one card: what the card answers.

Spawns two processes that both take ``cuda:0`` and join one NCCL group,
then run one all-reduce. Prints each rank's outcome (the sum, or the
error NCCL raised) as one JSON line per rank. Run on a machine with one
card:

    python scripts/nccl_two_ranks_one_card.py
"""

import datetime
import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, port: int) -> None:
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=60),
        )
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out["all_reduce"] = x.tolist()
    except Exception as err:  # the answer is the point: print it
        out["error"] = f"{type(err).__name__}: {err}"[:2000]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def main() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, port)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
        if p.is_alive():
            p.kill()
            p.join()
    print(json.dumps({"exitcodes": [p.exitcode for p in procs],
                      "devices": torch.cuda.device_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
