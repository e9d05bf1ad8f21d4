"""Atomic filesystem writes, shared by checkpoints, run artifacts and the
registry (a copy of the JAX package's ``utils/io.py`` without its fault
injection point)."""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


def atomic_write(path: str | Path, data: bytes) -> None:
    """Write via a temp file in the same directory and a rename, so a
    crash never leaves a torn file and a failed write never leaks the
    temp file."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise
