"""Atomic filesystem writes, shared by checkpoints, run artifacts and the
registry (a copy of the JAX package's ``utils/io.py``)."""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

from mlops_tpu_torch import faults


def atomic_write(path: str | Path, data: bytes) -> None:
    """Write via a temp file in the same directory and a rename, so a
    crash never leaves a torn file and a failed write never leaks the
    temp file."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        # Fault point: a kill between write and rename must leave the
        # target as it was, never a partial payload.
        faults.fire("io.atomic_write.midwrite")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise
