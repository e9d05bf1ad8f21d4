"""Training pipeline, the document route: data -> doc trainer ->
calibration -> monitor -> bundle -> registry.

A port of the JAX package's ``train/pipeline.py`` for one card:
``run_layout_training`` and ``_run_doc_training`` with their helpers
(run directory, data, split, per-step batches, resume, checkpoints,
packaging). The same config and data give the same batches in the same
order as the JAX trainer, and the run writes the same artifacts:
``metrics.jsonl``, ``doc_params.msgpack``, a ``doc`` bundle both
packages load, and a registry version. Pipeline- and tensor-parallel
training, the sequence-parallel ring and the dense single-record
trainer (the exact tier) are not ported and are refused.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from mlops_tpu_torch.bundle import msgpack, save_doc_bundle
from mlops_tpu_torch.bundle.registry import ModelRegistry
from mlops_tpu_torch.config import Config
from mlops_tpu_torch.data import Preprocessor, generate_synthetic, load_csv_columns
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.train.calibrate import calibration_record
from mlops_tpu_torch.train.checkpoint import (
    has_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from mlops_tpu_torch.train.long_context import (
    DocTrainStep,
    build_doc_model,
    make_doc_train_step,
    make_documents,
)
from mlops_tpu_torch.train.loop import TrainResult, metric_writers, packaged_or_raw
from mlops_tpu_torch.train.metrics import binary_metrics
from mlops_tpu_torch.utils.io import atomic_write
from mlops_tpu_torch.weights import load_params, unflatten_tree

# Documents per forward when the validation split is scored (the
# predict-file chunk): documents are independent, so the chunking changes
# memory, not results.
EVAL_CHUNK = 256


@dataclasses.dataclass
class PipelineResult:
    bundle_dir: Path | None
    model_uri: str | None
    train_result: TrainResult
    run_dir: Path


def new_run_dir(config: Config, run_name: str | None = None) -> Path:
    """``<registry.run_root>/<timestamp-or-name>/``, created."""
    run_dir = Path(config.registry.run_root) / (
        run_name or time.strftime("%Y%m%d-%H%M%S")
    )
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def load_training_data(config: Config) -> tuple[dict[str, list], np.ndarray]:
    """A labelled CSV if ``data.train_path`` is set (Parquet is not
    ported), else ``data.rows`` synthetic rows from ``data.seed``."""
    path = config.data.train_path
    if path:
        if path.endswith(".parquet"):
            raise ValueError(
                f"{path}: Parquet input is not ported; train from a CSV"
            )
        return load_csv_columns(path, require_target=True)
    return generate_synthetic(config.data.rows, seed=config.data.seed)


def split_dataset(
    ds: EncodedDataset, valid_fraction: float, seed: int = 2024
) -> tuple[EncodedDataset, EncodedDataset]:
    """Shuffled (train, valid) split, the JAX package's permutation."""
    perm = np.random.default_rng(seed).permutation(ds.n)
    n_valid = int(ds.n * valid_fraction)
    return ds.slice(perm[n_valid:]), ds.slice(perm[:n_valid])


def _journal_max_step(path: Path) -> int:
    """Highest step already in a metrics.jsonl (0 when absent), so a
    resumed run appends no duplicate rows; unreadable lines are skipped."""
    best = 0
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return 0
    for line in lines:
        try:
            best = max(best, int(json.loads(line)["step"]))
        except (ValueError, KeyError, TypeError):
            continue
    return best


def _batch_indices(n_rows: int, batch: int, seed: int, step: int) -> np.ndarray:
    """Minibatch indices for ONE step, seeded by (seed, step), exactly as
    the JAX trainer draws them: the data order is a function of the step,
    so a resumed run sees the batches the interrupted one would have."""
    return np.random.default_rng((seed, step)).integers(0, n_rows, batch)


def _final_validation_metrics(
    history: list[dict], steps: int, fallback: Callable[[], dict]
) -> dict[str, float]:
    """The last eval is the final metric set when the run reached its
    step budget; ``fallback`` covers a resume already at the budget."""
    if history and history[-1]["step"] == steps:
        return {k: v for k, v in history[-1].items() if k.startswith("validation_")}
    return fallback()


def _layout_run_setup(tcfg, run_dir: Path, trainer: DocTrainStep):
    """Eval and checkpoint cadences (``checkpoint_every=0`` falls back to
    the eval window), the state restored from the newest checkpoint, and
    the journal floor that suppresses duplicate metric rows on resume."""
    eval_every = max(1, min(tcfg.eval_every, tcfg.steps))
    ckpt_every = max(1, tcfg.checkpoint_every or eval_every)
    ckpt_dir = run_dir / "checkpoints"
    start_step = _restore_layout_state(ckpt_dir, trainer)
    journal_floor = _journal_max_step(run_dir / "metrics.jsonl")
    return eval_every, ckpt_every, ckpt_dir, start_step, journal_floor


def _restore_layout_state(ckpt_dir: Path, trainer: DocTrainStep) -> int:
    """Model, optimizer and EMA from the newest checkpoint that fits this
    trainer; the step to resume after (0 for a fresh start)."""
    if not has_checkpoints(ckpt_dir):
        return 0

    def restore(state: dict[str, Any]) -> None:
        want = trainer.model.state_dict()
        got = state["model"]
        if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
            raise ValueError("the model state does not fit this model")
        if (state.get("ema") is None) != (trainer.ema is None):
            raise ValueError("train.ema_decay was toggled between runs")
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.model.load_state_dict(got)
        if trainer.ema is not None:
            for name, e in trainer.ema.items():
                e.copy_(state["ema"][name])

    return load_checkpoint(ckpt_dir, restore) or 0


def _maybe_checkpoint(
    ckpt_dir: Path, trainer: DocTrainStep, step: int, ckpt_every: int, steps: int
) -> None:
    if step % ckpt_every == 0 or step == steps:
        state = {
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(),
        }
        if trainer.ema is not None:
            state["ema"] = trainer.ema
        save_checkpoint(ckpt_dir, state, step)


def _package_and_register(
    config: Config,
    run_dir: Path,
    model: torch.nn.Module,
    preprocessor: Preprocessor,
    train_ds: EncodedDataset,
    metrics: dict[str, float],
    bundle_tags: dict[str, str],
    registry_tags: dict[str, str],
    register: bool,
    calibration: dict[str, float],
) -> tuple[Path, str | None]:
    """The packaging tail: fit the monitors on the training split, write
    the ``doc`` bundle, register it."""
    bundle_dir = run_dir / "bundle"
    monitor = fit_monitor(
        train_ds,
        drift_ref_size=config.monitor.drift_ref_size,
        seed=config.data.seed,
        outlier_quantile=config.monitor.outlier_quantile,
    )
    save_doc_bundle(
        bundle_dir, config.model, model, preprocessor, monitor,
        calibration=calibration, tags=bundle_tags, metrics=metrics,
    )
    model_uri = None
    if register:
        model_uri = ModelRegistry(config.registry.root).register(
            config.registry.model_name, bundle_dir, tags=registry_tags
        )
    return bundle_dir, model_uri


def _refuse_unported(config: Config) -> None:
    """What the JAX ``train`` command accepts and this package does not
    train yet, refused before any work, each with its reason."""
    model = config.model
    if not model.uses_layout_trainer:
        raise ValueError(
            f"train with model.family={model.family!r} and doc_records="
            f"{model.doc_records} is the dense single-record trainer (the "
            "exact tier), which is not ported (ROADMAP.md A1); this package "
            "trains the long-context doc model (model.doc_records > 1)"
        )
    if model.pipeline_stages or model.tensor_parallel:
        raise ValueError(
            "pipeline-parallel (model.pipeline_stages) and tensor-parallel "
            "(model.tensor_parallel) training are not ported (ROADMAP.md "
            "A11); this package trains the dense doc model on one card"
        )
    if model.seq_parallel:
        raise ValueError(
            "model.seq_parallel=true (ring attention over a multi-device "
            "'seq' axis) is not ported (ROADMAP.md A11); on one card pass "
            "model.seq_parallel=false, the dense path"
        )
    if config.train.init_params:
        raise ValueError(
            "train.init_params is not supported for document training: the "
            "pretrained pos_embed covers one 48-token record, not a 2+46R "
            "document sequence"
        )


def run_layout_training(
    config: Config, register: bool = True, run_name: str | None = None
) -> PipelineResult:
    """Train the long-context doc model per config (``model.doc_records
    > 1``, dense attention) on ``train.device`` (the card unless "cpu"),
    and package and register it as a ``doc`` bundle."""
    _refuse_unported(config)
    device = resolve_device(config.train.device)
    if register:
        ModelRegistry(config.registry.root)  # refuses a gs:// root up front
    run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
    run_dir = new_run_dir(config, run_name)
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    return _run_doc_training(
        config, run_dir, run_name, preprocessor, train_ds, valid_ds, register,
        device,
    )


def _run_doc_training(
    config: Config,
    run_dir: Path,
    run_name: str,
    preprocessor: Preprocessor,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    register: bool,
    device: torch.device,
) -> PipelineResult:
    tcfg = config.train
    r = config.model.doc_records
    trainer = make_doc_train_step(config.model, tcfg, seed=tcfg.seed, device=device)
    dcat, dnum, dlab = (
        torch.from_numpy(a).to(device) for a in make_documents(train_ds, r)
    )
    vcat, vnum, vlab = make_documents(valid_ds, r)
    vcat_d, vnum_d = torch.from_numpy(vcat).to(device), torch.from_numpy(vnum).to(device)
    model = trainer.model

    def valid_doc_logits(params: dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            chunks = [
                functional_call(
                    model, params,
                    (vcat_d[lo: lo + EVAL_CHUNK], vnum_d[lo: lo + EVAL_CHUNK]),
                )
                for lo in range(0, vcat_d.shape[0], EVAL_CHUNK)
            ]
        return torch.cat(chunks) if chunks else torch.empty(0, device=device)

    def doc_eval(params: dict[str, torch.Tensor]) -> dict[str, float]:
        metrics = binary_metrics(
            valid_doc_logits(params), torch.from_numpy(vlab).to(device)
        )
        return {f"validation_{k}_score": round(float(v), 6) for k, v in metrics.items()}

    eval_every, ckpt_every, ckpt_dir, start_step, journal_floor = (
        _layout_run_setup(tcfg, run_dir, trainer)
    )

    def packaged_doc_params(step: int) -> dict[str, torch.Tensor]:
        # Evals and the shipped artifact use the debiased EMA when enabled.
        return packaged_or_raw(trainer.ema, trainer.params(), tcfg.ema_decay, step)

    history: list[dict] = []
    with metric_writers(run_dir / "metrics.jsonl", tcfg.tensorboard_dir) as emit:
        for step in range(start_step + 1, tcfg.steps + 1):
            idx = torch.from_numpy(
                _batch_indices(dcat.shape[0], tcfg.batch_size, tcfg.seed, step)
            ).to(device)
            loss = trainer.step(dcat[idx], dnum[idx], dlab[idx])
            if step % eval_every == 0 or step == tcfg.steps:
                record = {
                    "step": step,
                    "loss": round(float(loss), 6),
                    **doc_eval(packaged_doc_params(step)),
                }
                if step > journal_floor:  # no duplicate rows on resume
                    emit(record)
                history.append(record)
            _maybe_checkpoint(ckpt_dir, trainer, step, ckpt_every, tcfg.steps)

    final_params = packaged_doc_params(max(start_step, tcfg.steps))
    params_host = {k: v.detach().float().cpu() for k, v in final_params.items()}
    atomic_write(
        run_dir / "doc_params.msgpack", msgpack.packb(unflatten_tree(params_host))
    )
    final = _final_validation_metrics(
        history, tcfg.steps, lambda: doc_eval(final_params)
    )
    result = TrainResult(
        params=params_host,
        metrics=final,
        history=history,
        steps=tcfg.steps,
        packaged_step=tcfg.steps,
    )
    calibration = calibration_record(
        valid_doc_logits(final_params).cpu().numpy(), vlab
    )
    bundle_dir, model_uri = _package_and_register(
        config,
        run_dir,
        load_params(build_doc_model(config.model), params_host),
        preprocessor,
        train_ds,
        metrics=final,
        bundle_tags={
            "run_name": run_name or run_dir.name,
            "experiment": config.registry.experiment_name,
            "trained_with": "long_context dense",
        },
        registry_tags={
            "run_name": run_name or run_dir.name,
            **{k: f"{v:.6f}" for k, v in final.items()},
        },
        register=register,
        calibration=calibration,
    )
    return PipelineResult(
        bundle_dir=bundle_dir,
        model_uri=model_uri,
        train_result=result,
        run_dir=run_dir,
    )
