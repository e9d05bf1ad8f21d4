"""Device selection for the port's entry points, and streams that no two
holders share."""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch

# torch hands out the streams of its pool round robin, 32 per priority: the
# 33rd ``torch.cuda.Stream()`` of a process is the first one again. Streams
# taken through ``held_stream`` / ``own_stream`` skip any stream a live
# holder still has, so a lifecycle shadow engine built beside the serving
# engine (or a retrain) never gets the serving engine's streams.
_POOL_STREAMS = 32
_HELD: set[int] = set()
_HELD_LOCK = threading.Lock()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA on a machine without
    one raises (naming the missing card and the way to ask for the CPU);
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' (serve.device=cpu or "
            "train.device=cpu on the CLI) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _take(device: torch.device, capture: bool) -> torch.cuda.Stream:
    """A pooled stream of ``device`` no holder has; capture streams come
    from the high-priority pool, which nothing else in the port draws
    from, so no other thread's work ever lands on a stream being
    captured."""
    with _HELD_LOCK:
        for _ in range(_POOL_STREAMS):
            stream = torch.cuda.Stream(device, priority=-1 if capture else 0)
            if stream.cuda_stream not in _HELD:
                _HELD.add(stream.cuda_stream)
                return stream
    raise RuntimeError(
        f"all {_POOL_STREAMS} pooled streams of {device} are held"
    )


def _release(handle: int) -> None:
    with _HELD_LOCK:
        _HELD.discard(handle)


def held_stream(owner, device: torch.device, capture: bool = False) -> torch.cuda.Stream:
    """A stream of ``device`` that no other holder has, held until
    ``owner`` is collected (``capture``: for CUDA graph captures)."""
    stream = _take(device, capture)
    weakref.finalize(owner, _release, stream.cuda_stream)
    return stream


@contextlib.contextmanager
def own_stream(device: torch.device):
    """A stream of ``device`` that no other holder has, current and held
    for the ``with`` block."""
    stream = _take(device, capture=False)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        _release(stream.cuda_stream)
