"""Checkpoints of a training run: every ``checkpoint_every`` steps and
at the end, ``ckpt_<step>.pt`` beside a ``latest.json`` pointer, written
atomically; a rerun resumes from the newest one that loads.

The format is the port's own (``torch.save`` of the model, optimizer and
EMA state with the step), read back with ``weights_only=True``. The JAX
package checkpoints an optax ``opt_state`` tree of another layout, so
checkpoints do not cross between the packages (bundles do)."""

from __future__ import annotations

import io
import json
import warnings
from pathlib import Path
from typing import Any, Callable

import torch

from mlops_tpu_torch.utils.io import atomic_write

CKPT_GLOB = "ckpt_*.pt"


def save_checkpoint(directory: str | Path, state: dict[str, Any], step: int) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"ckpt_{step:08d}.pt"
    buf = io.BytesIO()
    torch.save(state, buf)
    atomic_write(path, buf.getvalue())
    atomic_write(
        directory / "latest.json",
        json.dumps({"step": step, "file": path.name}).encode(),
    )
    return path


def has_checkpoints(directory: str | Path) -> bool:
    directory = Path(directory)
    return (directory / "latest.json").exists() or any(directory.glob(CKPT_GLOB))


def load_checkpoint(
    directory: str | Path, restore: Callable[[dict[str, Any]], None]
) -> int | None:
    """Hand the newest readable checkpoint's state to ``restore`` (which
    raises if the state does not fit the run) and return its step.

    Tries the ``latest.json`` pointer first, then the ``ckpt_*.pt`` files
    newest first. None when there is nothing to restore; when checkpoints
    exist but none restores, warns loudly (most often ``train.ema_decay``
    was toggled between runs) and returns None: training restarts from
    step 0."""
    directory = Path(directory)
    candidates: list[tuple[Path, int | None]] = []
    latest = directory / "latest.json"
    if latest.exists():
        try:
            meta = json.loads(latest.read_text())
            candidates.append((directory / meta["file"], int(meta["step"])))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError, OSError):
            pass
    pointed = {path for path, _ in candidates}
    candidates.extend(
        (p, None)
        for p in sorted(directory.glob(CKPT_GLOB), reverse=True)
        if p not in pointed
    )
    failures = []
    for path, known_step in candidates:
        try:
            state = torch.load(
                io.BytesIO(path.read_bytes()), map_location="cpu", weights_only=True
            )
            step = known_step if known_step is not None else int(path.stem.split("_")[1])
            restore(state)
        except (OSError, RuntimeError, ValueError, KeyError, IndexError, TypeError) as err:
            failures.append((path, err))
            continue
        return step
    if failures:
        path, err = failures[0]
        warnings.warn(
            f"{len(failures)} checkpoint(s) in {directory} failed to restore "
            f"(first: {path.name}: {err}); training restarts from step 0 — "
            "if the state's shape changed (most commonly train.ema_decay "
            "toggled between runs), resume with the original settings or "
            "clear the checkpoint dir",
            stacklevel=2,
        )
    return None
