"""Build a CUDA C++ source of the package into a shared library.

The kernels have a plain C interface and are loaded with ``ctypes``, so a
build is one ``nvcc`` call of a few seconds. Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, and a later call (or another process) reuses a
library that is already there. Nothing here builds at import time.

Beside ``build_shared_library``: ``KernelLibrary`` (one source's
library, built and bound at first use) and ``LaunchCounter`` (the count
each kernel wrapper bumps where it launches).
"""

from __future__ import annotations

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

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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


def build_shared_library(source: Path, name: str) -> BuildResult:
    """Compile ``source`` into ``build/kernels/lib<name>-<hash>.so``."""
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(out, 0.0, log, reused=True)
    nvcc = find_nvcc()
    # Build under a private name and rename into place, so a concurrent
    # process never loads a half-written library.
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return BuildResult(out, seconds, log, reused=False)


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

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = build_shared_library(self.source, self.name).path
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
            return self._lib


class LaunchCounter:
    """How many times a kernel was launched: a plain integer the wrapper
    bumps at each launch (thread-safe; the server scores from a pool)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
