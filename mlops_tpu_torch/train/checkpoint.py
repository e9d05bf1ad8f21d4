"""Checkpoints of a training run: every ``checkpoint_every`` steps and
at the end, ``ckpt_<step>.pt`` beside a ``latest.json`` pointer, written
atomically; a rerun resumes from the newest one that loads. Beside them,
``train.keep_best``'s best-window snapshot (``save_best``/``load_best``),
so a resumed run continues the comparison.

The format is the port's own (``torch.save`` of the model's params, the
optimizer's state with its step count, and the EMA), read back with
``weights_only=True``. The JAX package checkpoints an optax
``opt_state`` tree of another layout, so checkpoints do not cross between
the packages (bundles do)."""

from __future__ import annotations

import io
import json
import warnings
from pathlib import Path
from typing import Any, Callable

import torch
from torch import nn

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


def train_state(
    model: nn.Module, optimizer: Any, ema: dict[str, torch.Tensor] | None
) -> dict[str, Any]:
    """What a checkpoint holds: the params, the optimizer's state and the
    EMA accumulator when there is one."""
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    if ema is not None:
        state["ema"] = ema
    return state


def restore_train_state(
    directory: str | Path,
    model: nn.Module,
    optimizer: Any,
    ema: dict[str, torch.Tensor] | None,
) -> int:
    """Params, optimizer and EMA from the newest checkpoint in
    ``directory`` that fits this run; the step to resume after (0 for a
    fresh start, or when none fits: ``load_checkpoint`` warns)."""
    if not has_checkpoints(directory):
        return 0

    def restore(state: dict[str, Any]) -> None:
        want = model.state_dict()
        got = state["model"]
        if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
            raise ValueError("the model state does not fit this model")
        if (state.get("ema") is None) != (ema is None):
            raise ValueError("train.ema_decay was toggled between runs")
        optimizer.load_state_dict(state["optimizer"])
        model.load_state_dict(got)
        if ema is not None:
            for name, e in ema.items():
                e.copy_(state["ema"][name])

    return load_checkpoint(directory, restore) or 0


BEST_PARAMS_NAME = "best_params.pt"
BEST_RECORD_NAME = "best_record.json"


def save_best(
    directory: str | Path, params: dict[str, torch.Tensor], record: dict
) -> None:
    """Persist the best eval window's params and record
    (``train.keep_best``)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(params, buf)
    atomic_write(directory / BEST_PARAMS_NAME, buf.getvalue())
    atomic_write(directory / BEST_RECORD_NAME, json.dumps(record).encode())


def load_best(
    directory: str | Path, template: dict[str, torch.Tensor]
) -> tuple[dict[str, torch.Tensor], dict] | None:
    """The persisted best snapshot, or None when it is absent, unreadable
    or does not fit ``template`` (the params' names and shapes)."""
    directory = Path(directory)
    try:
        params = torch.load(
            io.BytesIO((directory / BEST_PARAMS_NAME).read_bytes()),
            map_location="cpu",
            weights_only=True,
        )
        record = json.loads((directory / BEST_RECORD_NAME).read_text())
        float(record["validation_roc_auc_score"])
    except (OSError, RuntimeError, ValueError, KeyError, TypeError):
        return None
    if set(params) != set(template) or any(
        params[k].shape != template[k].shape for k in template
    ):
        return None
    return params, record
