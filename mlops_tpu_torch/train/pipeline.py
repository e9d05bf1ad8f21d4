"""Training pipeline: data -> trainer -> calibration -> monitor ->
bundle -> registry.

A port of the JAX package's ``train/pipeline.py`` for one card, both
routes with their helpers (run directory, data, split, resume,
checkpoints, packaging):

- ``run_training``, the dense single-record trainer of the exact tier
  (linear, mlp, FT-Transformer, mixture-of-experts, single-record BERT
  and deep ensembles of any of them; with ``train.init_params`` a bert
  fine-tune from a pretrained masked-LM trunk, ``train/pretrain.py``):
  ``loop.fit``, temperature calibration on the packaged params, the
  distilled students (``train/distill.py``: the bulk student of an
  ensemble or a transformer family unless ``train.distill_bulk`` is off,
  the quant tier with ``train.distill_quant``), a ``flax`` bundle both
  packages load;
- ``run_layout_training`` and ``_run_doc_training``, the long-context
  doc model: a ``doc`` bundle and ``doc_params.msgpack``;
- ``run_tuning``, the ``tune`` sweep (``train/hpo.py``): every trial of
  every architecture group stacked, the winner calibrated, its bulk
  student distilled when its family takes one, packaged and registered.

The same config and data give the same batches in the same order on the
CPU and the card; each run writes ``metrics.jsonl`` (and TensorBoard
events with ``train.tensorboard_dir``), checkpoints, a bundle and a
registry version. ``data.train_path`` may be a CSV or a Parquet file and
it and ``registry.root`` may be ``gs://`` URIs, as in the JAX package.
The sklearn tree-ensemble floor (gbm, rf) trains on the host through
scikit-learn, as in the JAX package, into an ``sklearn`` bundle. What the
JAX ``train`` command accepts and the port does not train yet (pipeline-
and tensor-parallel training, the sequence-parallel ring) is refused
before any work, naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from mlops_tpu_torch.bundle import (
    msgpack,
    save_doc_bundle,
    save_exact_bundle,
    save_sklearn_bundle,
)
from mlops_tpu_torch.bundle.registry import ModelRegistry
from mlops_tpu_torch.config import Config, ModelConfig
from mlops_tpu_torch.data import Preprocessor, generate_synthetic, load_table_columns
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.models.gbm import SKLEARN_FAMILIES, SklearnBaseline
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.train.calibrate import calibration_record, probs_to_logits
from mlops_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_checkpoint,
    train_state,
)
from mlops_tpu_torch.train.distill import (
    DistillResult,
    QuantDistillResult,
    distill_for_bulk,
    distill_quant_student,
)
from mlops_tpu_torch.train.long_context import (
    DocTrainStep,
    build_doc_model,
    check_doc_attention,
    make_doc_train_step,
    make_documents,
)
from mlops_tpu_torch.train.hpo import HPOResult, run_architecture_hpo
from mlops_tpu_torch.train.loop import (
    TrainResult,
    batch_indices,
    eval_logits,
    fit,
    journal_max_step,
    metric_writers,
    packaged_or_raw,
)
from mlops_tpu_torch.train.metrics import binary_metrics
from mlops_tpu_torch.train.pretrain import load_pretrained_variables
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
    """A labelled CSV or Parquet file (local or ``gs://``) if
    ``data.train_path`` is set, else ``data.rows`` synthetic rows from
    ``data.seed``."""
    if config.data.train_path:
        return load_table_columns(config.data.train_path, require_target=True)
    return generate_synthetic(config.data.rows, seed=config.data.seed)


def split_dataset(
    ds: EncodedDataset, valid_fraction: float, seed: int = 2024
) -> tuple[EncodedDataset, EncodedDataset]:
    """Shuffled (train, valid) split, the JAX package's permutation."""
    perm = np.random.default_rng(seed).permutation(ds.n)
    n_valid = int(ds.n * valid_fraction)
    return ds.slice(perm[n_valid:]), ds.slice(perm[:n_valid])


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
    start_step = restore_train_state(
        ckpt_dir, trainer.model, trainer.optimizer, trainer.ema
    )
    journal_floor = journal_max_step(run_dir / "metrics.jsonl")
    return eval_every, ckpt_every, ckpt_dir, start_step, journal_floor


def _maybe_checkpoint(
    ckpt_dir: Path, trainer: DocTrainStep, step: int, ckpt_every: int, steps: int
) -> None:
    if step % ckpt_every == 0 or step == steps:
        save_checkpoint(
            ckpt_dir, train_state(trainer.model, trainer.optimizer, trainer.ema), step
        )


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
    students: dict | None = None,
    model_config: ModelConfig | None = None,
) -> tuple[Path, str | None]:
    """The packaging tail: fit the monitors on the training split, write
    the bundle of ``model_config`` (``config.model`` when None; ``doc``
    for a doc model, ``sklearn`` for a tree ensemble, whose ``model`` is
    the ``SklearnBaseline``, else ``flax`` with the ``students`` keywords
    of ``save_exact_bundle``), register it."""
    model_config = model_config or config.model
    bundle_dir = run_dir / "bundle"
    monitor = fit_monitor(
        train_ds,
        drift_ref_size=config.monitor.drift_ref_size,
        seed=config.data.seed,
        outlier_quantile=config.monitor.outlier_quantile,
    )
    if model_config.family in SKLEARN_FAMILIES:
        save_sklearn_bundle(
            bundle_dir, model_config, preprocessor, monitor, estimator=model,
            calibration=calibration, tags=bundle_tags, metrics=metrics,
        )
    else:
        save = save_doc_bundle if model_config.doc_records > 1 else save_exact_bundle
        save(
            bundle_dir, model_config, model, preprocessor, monitor,
            calibration=calibration, tags=bundle_tags, metrics=metrics,
            **(students or {}),
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
        # The JAX package's guard: a dense config routed here would train
        # a one-record "document" model.
        raise ValueError(
            "run_layout_training needs a layout knob set "
            "(model.pipeline_stages / seq_parallel / doc_records>1); "
            "dense configs train via run_training"
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


# The JAX package's package-time distillation gate (``_maybe_distill``):
# ensembles and these families ship a bulk student unless
# train.distill_bulk is off.
_DISTILL_FAMILIES = ("ft_transformer", "moe", "bert")


def _maybe_distill(
    config: Config, teacher: torch.nn.Module, train_ds, valid_ds, device,
    model_config: ModelConfig | None = None,
) -> DistillResult | None:
    """The bulk student of an ensemble or a transformer family (the
    families whose per-row FLOPs the JAX package distills away for CPU
    bulk sweeps) of ``model_config`` (``config.model`` when None), unless
    ``train.distill_bulk`` turned it off."""
    model_config = model_config or config.model
    expensive = (
        model_config.ensemble_size > 1 or model_config.family in _DISTILL_FAMILIES
    )
    if not expensive or not config.train.distill_bulk:
        return None
    return distill_for_bulk(
        teacher, model_config, train_ds, valid_ds, seed=config.train.seed,
        device=device,
    )


def _maybe_distill_quant(
    config: Config, teacher: torch.nn.Module, train_ds, valid_ds, device
) -> QuantDistillResult | None:
    """The quant tier, opt-in (``train.distill_quant``): the quantized
    student with its fidelity record, refit temperature and stamped gate
    decision, which the engine admits the tier by."""
    if not config.train.distill_quant:
        return None
    return distill_quant_student(
        teacher, train_ds, valid_ds, seed=config.train.seed,
        lifecycle=config.lifecycle, device=device,
    )


def _refuse_unported_dense(config: Config) -> None:
    """What the JAX ``run_training`` accepts and this package does not
    train yet, refused before any work, each with its ROADMAP item."""
    model = config.model
    if model.uses_layout_trainer:
        raise ValueError(
            "run_training trains the single-record dense model; multi-device "
            "training layouts have dedicated trainers (model.doc_records -> "
            "run_layout_training, which the `train` CLI dispatches to)"
        )


def load_init_state(config: Config) -> dict[str, torch.Tensor] | None:
    """``train.init_params``: the pretrained masked-LM trunk grafted into
    a fresh init of the model from ``train.seed``; None when unset. An
    ensemble, a family other than bert, a missing file or a tree that
    does not match raise as in the JAX package."""
    if not config.train.init_params:
        return None
    fresh = init_params(build_model(config.model), config.train.seed)
    return load_pretrained_variables(
        config.train.init_params, config.model, fresh.state_dict()
    )


def run_training(
    config: Config, register: bool = True, run_name: str | None = None
) -> PipelineResult:
    """Train one exact-tier model per config on ``train.device`` (the
    card unless "cpu") and package and register it as a ``flax`` bundle:
    data, ``Preprocessor.fit``, the seed-2024 split, ``fit``, a
    temperature fitted on the packaged params' validation logits, the
    bulk and quant students (``_maybe_distill``, ``_maybe_distill_quant``)
    distilled from the packaged params, the monitors, the bundle, the
    registry. With ``train.init_params`` the model starts from a fresh
    init (``train.seed``) with the pretrained trunk grafted in
    (``load_init_state``); a checkpoint still wins over it. The sklearn
    families (gbm, rf) take the JAX package's branch
    (``_run_sklearn_training``)."""
    _refuse_unported_dense(config)
    if config.model.family in SKLEARN_FAMILIES:
        return _run_sklearn_training(config, register, run_name)
    device = resolve_device(config.train.device)
    model = build_model(config.model)  # refuses what the zoo does not port
    init_state = load_init_state(config)  # before any work: a bad file raises
    run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
    run_dir = new_run_dir(config, run_name)
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    result = fit(
        model, train_ds, valid_ds, config.train,
        init_state=init_state,
        metrics_path=run_dir / "metrics.jsonl",
        checkpoint_dir=run_dir / "checkpoints",
        device=device,
    )
    packaged = load_params(build_model(config.model), result.params).to(device)
    logits = eval_logits(
        packaged,
        dict(packaged.named_parameters()),
        torch.from_numpy(valid_ds.cat_ids).to(device),
        torch.from_numpy(valid_ds.numeric).to(device),
    )
    calibration = calibration_record(logits.cpu().numpy(), valid_ds.labels)
    bulk = _maybe_distill(config, packaged, train_ds, valid_ds, device)
    quant = _maybe_distill_quant(config, packaged, train_ds, valid_ds, device)
    students = {"bulk": bulk}
    if quant is not None:
        students["quant_params"] = quant.qparams
        students["quant"] = {
            "fidelity": quant.fidelity,
            "temperature": quant.temperature,
            "gates": quant.gates,
        }
    bundle_dir, model_uri = _package_and_register(
        config,
        run_dir,
        packaged.cpu(),
        preprocessor,
        train_ds,
        metrics=result.metrics,
        bundle_tags={"run_name": run_name, "experiment": config.registry.experiment_name},
        registry_tags={
            "run_name": run_name,
            **{k: f"{v:.6f}" for k, v in result.metrics.items()},
        },
        register=register,
        calibration=calibration,
        students=students,
    )
    return PipelineResult(
        bundle_dir=bundle_dir, model_uri=model_uri, train_result=result, run_dir=run_dir
    )


def _run_sklearn_training(
    config: Config, register: bool, run_name: str | None
) -> PipelineResult:
    """The JAX ``run_training``'s sklearn branch (BASELINE config 1, the
    tree-ensemble floor) on the host: the same data, preprocessor and
    split, ``SklearnBaseline.train``, its validation metrics, a
    temperature fitted on the logits of its clipped validation
    probabilities, no students (the floor is what they are measured
    against), and an ``sklearn`` bundle: the estimator and, for a HistGBM
    ensemble, the tree file the gbm tier serves. Needs scikit-learn."""
    run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
    run_dir = new_run_dir(config, run_name)
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    baseline = SklearnBaseline.train(config.model, config.train, train_ds)
    result = TrainResult(
        params=baseline,
        metrics=baseline.evaluate(valid_ds),
        history=[],
        steps=config.model.n_estimators,
    )
    calibration = calibration_record(
        probs_to_logits(baseline.predict_proba(valid_ds.cat_ids, valid_ds.numeric)),
        valid_ds.labels,
    )
    bundle_dir, model_uri = _package_and_register(
        config,
        run_dir,
        baseline,
        preprocessor,
        train_ds,
        metrics=result.metrics,
        bundle_tags={"run_name": run_name, "experiment": config.registry.experiment_name},
        registry_tags={
            "run_name": run_name,
            **{k: f"{v:.6f}" for k, v in result.metrics.items()},
        },
        register=register,
        calibration=calibration,
    )
    return PipelineResult(
        bundle_dir=bundle_dir, model_uri=model_uri, train_result=result, run_dir=run_dir
    )


def run_layout_training(
    config: Config, register: bool = True, run_name: str | None = None
) -> PipelineResult:
    """Train the long-context doc model per config (``model.doc_records
    > 1``, dense attention) on ``train.device`` (the card unless "cpu"),
    and package and register it as a ``doc`` bundle."""
    _refuse_unported(config)
    device = resolve_device(config.train.device)
    check_doc_attention(config.model, device)
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
        return eval_logits(model, params, vcat_d, vnum_d, EVAL_CHUNK)

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
                batch_indices(dcat.shape[0], tcfg.batch_size, tcfg.seed, step)
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


def run_tuning(
    config: Config, register: bool = True, run_name: str | None = None
) -> tuple[PipelineResult, HPOResult]:
    """The ``tune`` sweep on ``train.device`` (the card unless "cpu"),
    then the winner packaged: the JAX package's ``run_tuning``. Every
    ``hpo.architectures`` group (or the configured model alone) trains
    its ``hpo.trials`` trials stacked for ``hpo.steps`` steps
    (``train/hpo.py``); groups persist under ``<run_dir>/hpo_groups`` as
    they finish, so a rerun with the same ``registry.run_name`` trains
    only the unfinished ones. ``trials.jsonl`` (a full atomic rewrite)
    and ``best.json`` record the sweep; the winner's architecture is
    calibrated on the validation split, distills its bulk student when
    its family takes one (never a quant student), and is packaged and
    registered. ``train.steps``, ``keep_best`` and the eval windows are
    not read, as in the JAX package."""
    model = config.model
    if model.family in ("gbm", "rf"):
        raise ValueError(
            "sklearn baseline families (gbm/rf) train via `train`; the "
            "vmapped/sharded `tune` sweep applies to the Flax families only"
        )
    if model.uses_layout_trainer:
        raise ValueError(
            "`tune` sweeps dense single-record models; layout knobs "
            "(model.pipeline_stages / seq_parallel / doc_records>1) train "
            "via `train` -> run_layout_training"
        )
    device = resolve_device(config.train.device)
    run_name = run_name or time.strftime("%Y%m%d-%H%M%S") + "-tune"
    run_dir = new_run_dir(config, run_name)
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    t0 = time.perf_counter()
    win_model, hpo_result = run_architecture_hpo(
        model, config.train, config.hpo, train_ds, valid_ds,
        device=device, resume_dir=run_dir,
    )
    logging.getLogger(__name__).info(
        "tune: %d trials swept in %.3f s on %s",
        len(hpo_result.trials), time.perf_counter() - t0, device,
    )
    # A full rewrite, not an append: the records cover every trial,
    # restored groups included, so a retried run duplicates nothing.
    atomic_write(
        run_dir / "trials.jsonl",
        "".join(
            json.dumps({"trial": i, **trial}, default=float) + "\n"
            for i, trial in enumerate(hpo_result.trials)
        ).encode(),
    )
    atomic_write(
        run_dir / "best.json",
        json.dumps(
            {
                "best_index": hpo_result.best_index,
                "hyperparams": hpo_result.best_hyperparams,
                "metrics": hpo_result.best_metrics,
            },
            indent=2,
        ).encode(),
    )
    packaged = load_params(build_model(win_model), hpo_result.best_params).to(device)
    logits = eval_logits(
        packaged,
        dict(packaged.named_parameters()),
        torch.from_numpy(valid_ds.cat_ids).to(device),
        torch.from_numpy(valid_ds.numeric).to(device),
    )
    calibration = calibration_record(logits.cpu().numpy(), valid_ds.labels)
    bulk = _maybe_distill(
        config, packaged, train_ds, valid_ds, device, model_config=win_model
    )
    best_trial = str(hpo_result.best_index)
    bundle_dir, model_uri = _package_and_register(
        config,
        run_dir,
        packaged.cpu(),
        preprocessor,
        train_ds,
        metrics=hpo_result.best_metrics,
        bundle_tags={
            "run_name": run_name,
            "best_trial": best_trial,
            # Structural winners (family/hidden_dims/...) surface as strings.
            **{
                k: (f"{v:.6g}" if isinstance(v, float) else str(v))
                for k, v in hpo_result.best_hyperparams.items()
            },
        },
        registry_tags={"run_name": run_name, "best_trial": best_trial},
        register=register,
        calibration=calibration,
        students={"bulk": bulk},
        model_config=win_model,
    )
    result = PipelineResult(
        bundle_dir=bundle_dir,
        model_uri=model_uri,
        train_result=TrainResult(
            params=hpo_result.best_params,
            metrics=hpo_result.best_metrics,
            history=[],
            steps=config.hpo.steps,
        ),
        run_dir=run_dir,
    )
    return result, hpo_result
