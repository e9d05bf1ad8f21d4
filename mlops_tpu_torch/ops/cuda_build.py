"""Build a CUDA C++ source of the package into a shared library.

The kernels have a plain C interface and are loaded with ``ctypes``, so a
build is one ``nvcc`` call of a few seconds. Libraries land in
``build/kernels/`` at the root of the checkout, or in
``<cache.dir>/kernels/`` once ``set_cache_dir`` names a cache (the warm
start, ``compilecache/``), named by a hash of the source and the flags,
and a later call (or another process) reuses a library that is already
there. Each library is written under a private name and renamed into
place, with the sha256 of its bytes beside it; a library whose bytes do
not match (truncated, corrupted) is discarded, counted
(``cache_discards``) and rebuilt, never loaded. The fault points
``compilecache.read`` (the bytes read for that check) and
``compilecache.persist.midwrite`` (between a build's tmp write and its
rename) drive both paths. Nothing here builds at import time.

Beside ``build_shared_library``: ``KernelLibrary`` (one source's
library, built and bound at first use) and ``LaunchCounter`` (the count
each kernel wrapper bumps where it launches; ``LAUNCH_COUNTERS`` lists
them all). ``kernel_output_observer`` hands each launch's outputs to a
checker on the launching thread (``utils/debug.checked``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

from mlops_tpu_torch import faults

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


_cache_dir: Path | None = None
_nvcc_calls = 0  # nvcc runs of this process (a warm start makes none)
_discards = 0  # libraries whose bytes did not match their sha256


def set_cache_dir(cache_dir: str | Path | None) -> None:
    """Build into and load from ``<cache_dir>/kernels/`` (``cache.dir``);
    None or empty goes back to ``build/kernels/``."""
    global _cache_dir
    _cache_dir = Path(cache_dir) if cache_dir else None


def cache_dir() -> Path | None:
    """The directory ``set_cache_dir`` gave (None: ``build/kernels/``)."""
    return _cache_dir


def kernel_dir() -> Path:
    return _cache_dir / "kernels" if _cache_dir is not None else BUILD_DIR


def nvcc_calls() -> int:
    return _nvcc_calls


def cache_discards() -> int:
    return _discards


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # wall time of the nvcc call, 0.0 when reused
    log: str  # nvcc's output, including the -Xptxas -v summary
    reused: bool


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME`` (or /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _atomic_write(path: Path, data: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(data)
    os.replace(tmp, path)


def build_shared_library(source: Path, name: str) -> BuildResult:
    """Compile ``source`` into ``<kernel dir>/lib<name>-<hash>.so``, or
    reuse the library there when its recorded sha256 matches its bytes.

    The hash covers the source, the headers (``*.cuh``) beside it, which
    a source includes by relative path, and the flags.
    """
    global _nvcc_calls, _discards
    source = Path(source)
    headers = sorted(source.parent.glob("*.cuh"))
    digest = hashlib.sha256(
        b"".join(path.read_bytes() for path in (source, *headers))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = kernel_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    sum_path = out.with_name(out.name + ".sha256")
    if out.exists():
        recorded = sum_path.read_text().strip() if sum_path.exists() else ""
        # Fault point: bit flips in the bytes read must land in the
        # discard and rebuild below.
        raw = faults.corrupt("compilecache.read", out.read_bytes())
        if recorded == hashlib.sha256(raw).hexdigest():
            log = log_path.read_text() if log_path.exists() else ""
            return BuildResult(out, 0.0, log, reused=True)
        # A library that is not the one that was written: never loaded.
        out.unlink(missing_ok=True)
        _discards += 1
    nvcc = find_nvcc()
    # Build under a private name and rename into place, so a concurrent
    # process never loads a half-written library.
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    _nvcc_calls += 1
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    _atomic_write(log_path, log)
    _atomic_write(sum_path, _sha256(tmp))
    # Fault point: a kill between the tmp write and the rename must leave
    # no library under the final name.
    faults.fire("compilecache.persist.midwrite")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log, reused=False)


# Every kernel library of the package, in the order their modules made
# them (what ``warmup`` builds without a bundle).
KERNEL_LIBRARIES: list["KernelLibrary"] = []

# tpulint Layer-3 manifest: each library's lock guards its one build
# and load; each counter's guards its integer. Both are leaves.
TPULINT_LOCK_ORDER = {"KernelLibrary": ("_lock",), "LaunchCounter": ("_lock",)}


class KernelLibrary:
    """One kernel source's shared library: built (first use only), loaded
    with ``ctypes`` and given its C signatures by ``bind``, once per
    process."""

    def __init__(
        self, source: Path, name: str, bind: Callable[[ctypes.CDLL], None]
    ) -> None:
        self.source = Path(source)
        self.name = name
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        KERNEL_LIBRARIES.append(self)

    def build(self) -> BuildResult:
        """Build the library into the kernel directory, or reuse it."""
        return build_shared_library(self.source, self.name)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build().path))
                self._bind(lib)
                self._lib = lib
            return self._lib


# Every launch counter of the package, for what counts launches across
# kernels (the CUDA graphs of ``serve/graphs.py``).
LAUNCH_COUNTERS: list["LaunchCounter"] = []

# The launching thread's observer of kernel outputs, if any.
_OBSERVER = threading.local()


@contextlib.contextmanager
def kernel_output_observer(observe: Callable[[str, tuple, tuple], None]):
    """Within the block, each kernel launch this thread makes outside a
    graph capture calls ``observe(kernel name, output tensors, operand
    tensors)`` after it was enqueued."""
    previous = getattr(_OBSERVER, "fn", None)
    _OBSERVER.fn = observe
    try:
        yield
    finally:
        _OBSERVER.fn = previous


class LaunchCounter:
    """How many times a kernel was launched: a plain integer the wrapper
    bumps at each launch (thread-safe; the server scores from a pool).

    A launch made while the calling thread's stream is being captured
    into a CUDA graph runs nothing then: it counts in this thread's
    ``captured`` instead, and each replay of the graph adds it
    (``serve/graphs.py``)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._local = threading.local()
        self.value = 0
        LAUNCH_COUNTERS.append(self)

    @property
    def captured(self) -> int:
        """Launches this thread has recorded into CUDA graphs."""
        return getattr(self._local, "captured", 0)

    def add(self, n: int = 1, outputs: tuple = (), inputs: tuple = ()) -> None:
        """Count ``n`` launches; ``outputs``, the tensors the launch
        writes, and ``inputs``, those it reads, go to the thread's
        ``kernel_output_observer``."""
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self._local.captured = self.captured + n
            return
        with self._lock:
            self.value += n
        observe = getattr(_OBSERVER, "fn", None)
        if observe is not None and outputs:
            observe(self.name, outputs, inputs)

    def reset(self) -> None:
        with self._lock:
            self.value = 0
