"""Build a CUDA C++ source of the package into a shared library.

The kernels have a plain C interface and are loaded with ``ctypes``, so a
build is one ``nvcc`` call of a few seconds. Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, and a later call (or another process) reuses a
library that is already there. Nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
