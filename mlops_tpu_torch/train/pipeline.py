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
- ``run_layout_training``, the multi-rank layouts of the JAX package's
  ``run_layout_training``: ``model.tensor_parallel=K`` (DP x TP,
  ``train/tensor_parallel.py``) and ``model.pipeline_stages=S`` (DP x
  PP, ``train/pipeline_parallel.py``) into a ``flax`` bundle of the dense
  family, and the long-context doc model (``_run_doc_training``, DP x SP
  with ``model.seq_parallel``) into a ``doc`` bundle and
  ``doc_params.msgpack``; one rank per card under ``torch.distributed``
  (``parallel/distributed.py``), where only the coordinator (rank 0)
  writes the run directory, metrics, checkpoints, bundle and registry
  entry, and every rank returns the same result;
- ``run_tuning``, the ``tune`` sweep (``train/hpo.py``): every trial of
  every architecture group stacked, the winner calibrated, its bulk
  student distilled when its family takes one, packaged and registered.

The same config and data give the same batches in the same order on the
CPU and the card; each run writes ``metrics.jsonl`` (and TensorBoard
events with ``train.tensorboard_dir``), checkpoints, a bundle and a
registry version. ``data.train_path`` may be a CSV or a Parquet file and
it and ``registry.root`` may be ``gs://`` URIs, as in the JAX package.
The sklearn tree-ensemble floor (gbm, rf) trains on the host through
scikit-learn, as in the JAX package, into an ``sklearn`` bundle. The
world size takes the place of the JAX package's device count wherever a
mesh is sized, and its refusals (knobs that cannot combine, a count the
layout does not divide) are its messages.
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
from mlops_tpu_torch.parallel.distributed import (
    broadcast_object,
    initialize,
    is_coordinator,
    rank_device,
    world_size,
)
from mlops_tpu_torch.parallel.mesh import make_nd_mesh
from mlops_tpu_torch.train.calibrate import calibration_record, probs_to_logits
from mlops_tpu_torch.train.checkpoint import (
    has_checkpoints,
    load_checkpoint,
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
    evaluate,
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


def _shared_run_dir(config: Config, run_name: str | None) -> tuple[str, Path]:
    """The coordinator's run name on every rank (a timestamp when None)
    and its run directory, which only the coordinator creates."""
    run_name = broadcast_object(run_name or time.strftime("%Y%m%d-%H%M%S"))
    if is_coordinator():
        return run_name, new_run_dir(config, run_name)
    return run_name, Path(config.registry.run_root) / run_name


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


def _layout_run_setup(tcfg, run_dir: Path, trainer):
    """Eval and checkpoint cadences (``checkpoint_every=0`` falls back to
    the eval window), the state restored from the newest checkpoint, and
    the journal floor that suppresses duplicate metric rows on resume.
    ``trainer`` is the doc model's ``DocTrainStep`` or a laid-out step
    (``ShardedTrainStep``: every rank takes its blocks of the whole
    checkpointed state)."""
    eval_every = max(1, min(tcfg.eval_every, tcfg.steps))
    ckpt_every = max(1, tcfg.checkpoint_every or eval_every)
    ckpt_dir = run_dir / "checkpoints"
    if isinstance(trainer, DocTrainStep):
        start_step = restore_train_state(
            ckpt_dir, trainer.model, trainer.optimizer, trainer.ema
        )
    else:
        start_step = (
            load_checkpoint(ckpt_dir, trainer.load_full_state) or 0
            if has_checkpoints(ckpt_dir) else 0
        )
    journal_floor = journal_max_step(run_dir / "metrics.jsonl")
    return eval_every, ckpt_every, ckpt_dir, start_step, journal_floor


def _maybe_checkpoint(
    ckpt_dir: Path, trainer, step: int, ckpt_every: int, steps: int
) -> None:
    """Every ``ckpt_every`` steps and at the end: the whole state (a
    laid-out step gathers it on every rank), written by the coordinator."""
    if step % ckpt_every == 0 or step == steps:
        if isinstance(trainer, DocTrainStep):
            state = train_state(trainer.model, trainer.optimizer, trainer.ema)
        else:
            state = trainer.full_state()
        if is_coordinator():
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
    students: dict | None = None,
    model_config: ModelConfig | None = None,
) -> tuple[Path, str | None]:
    """The packaging tail: fit the monitors on the training split, write
    the bundle of ``model_config`` (``config.model`` when None; ``doc``
    for a doc model, ``sklearn`` for a tree ensemble, whose ``model`` is
    the ``SklearnBaseline``, else ``flax`` with the ``students`` keywords
    of ``save_exact_bundle``), register it. In a multi-rank run only the
    coordinator writes; the other ranks return the bundle path and no
    URI (the caller hands them the coordinator's)."""
    model_config = model_config or config.model
    bundle_dir = run_dir / "bundle"
    if not is_coordinator():
        return bundle_dir, None
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


def _check_layout_knobs(config: Config) -> None:
    """Refuse layout knobs that have no trainer together (the JAX
    package's check): each knob selects its own trainer, and the dispatch
    order would otherwise train only one of them."""
    knobs = {
        "pipeline_stages": bool(config.model.pipeline_stages),
        "tensor_parallel": bool(config.model.tensor_parallel),
        "doc_records>1/seq_parallel": (
            config.model.doc_records > 1 or config.model.seq_parallel
        ),
    }
    active = [name for name, on in knobs.items() if on]
    if len(active) > 1:
        raise ValueError(
            f"layout knobs {active} cannot combine: each selects its own "
            "trainer (PP / DP×TP / DP×SP documents); set exactly one"
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
    (``_run_sklearn_training``).

    Under a launcher (world size > 1) every rank joins its group and
    trains the same model on its own card (``cuda:LOCAL_RANK``), as every
    JAX process computes the same; only the coordinator writes the run
    directory, its metrics and checkpoints, the bundle and the registry
    entry, and every rank returns its URI."""
    _refuse_unported_dense(config)
    device = (
        initialize(config.train.device).device if world_size() > 1
        else resolve_device(config.train.device)
    )
    if config.model.family in SKLEARN_FAMILIES:
        return _run_sklearn_training(config, register, run_name)
    model = build_model(config.model)  # refuses what the zoo does not port
    init_state = load_init_state(config)  # before any work: a bad file raises
    run_name, run_dir = _shared_run_dir(config, run_name)
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
        bundle_dir=bundle_dir, model_uri=broadcast_object(model_uri),
        train_result=result, run_dir=run_dir,
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
    run_name, run_dir = _shared_run_dir(config, run_name)
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
        bundle_dir=bundle_dir, model_uri=broadcast_object(model_uri),
        train_result=result, run_dir=run_dir,
    )


def run_layout_training(
    config: Config, register: bool = True, run_name: str | None = None
) -> PipelineResult:
    """The multi-rank layouts (the JAX package's ``run_layout_training``;
    the ``train`` CLI dispatches here for a layout knob):

    - ``model.pipeline_stages=S``: GPipe on a ``('data', 'stage')`` mesh
      of the world's ranks; the stages merge back into the dense tree,
      which is calibrated, distilled, packaged and registered like any
      bundle of its family;
    - ``model.tensor_parallel=K``: DP x TP on ``('data', 'model')``, the
      same tail;
    - ``model.doc_records>1``: the doc model, on a ``('data', 'seq')``
      ring mesh with ``seq_parallel``, into a ``doc`` bundle.

    Each rank trains on ``train.device`` (the card ``cuda:LOCAL_RANK``
    unless "cpu"), joined to its group over NCCL or gloo; a plain run is
    a world of one. A mesh the world size does not fit is refused with
    the JAX package's message."""
    model = config.model
    if not model.uses_layout_trainer:
        # The mirror of run_training's guard: a dense config routed here
        # would train a one-record "document" model.
        raise ValueError(
            "run_layout_training needs a layout knob set "
            "(model.pipeline_stages / seq_parallel / doc_records>1); "
            "dense configs train via run_training"
        )
    _check_layout_knobs(config)
    if config.train.init_params:
        # Before the run dir and the data: an incompatible graft leaves
        # no orphan run directory.
        if not (model.pipeline_stages or model.tensor_parallel):
            raise ValueError(
                "train.init_params is not supported for document training: "
                "the pretrained pos_embed covers one 48-token record, not "
                "a 2+46R document sequence"
            )
        if model.family != "bert":
            raise ValueError(
                "train.init_params grafts a bert masked-LM trunk; "
                f"family {model.family!r} shares no trunk with it"
            )
    meshed = bool(model.pipeline_stages or model.tensor_parallel or model.seq_parallel)
    if meshed or world_size() > 1:
        device = initialize(config.train.device).device
    else:
        device = rank_device(config.train.device)
    if not (model.pipeline_stages or model.tensor_parallel):
        check_doc_attention(model, device)
    run_name, run_dir = _shared_run_dir(config, run_name)
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    run = (
        _run_pp_training if model.pipeline_stages
        else _run_tp_training if model.tensor_parallel
        else _run_doc_training
    )
    result = run(
        config, run_dir, run_name, preprocessor, train_ds, valid_ds, register, device
    )
    # The coordinator's URI on every rank, once its bundle is written.
    result.model_uri = broadcast_object(result.model_uri)
    return result


def _layout_metrics_path(run_dir: Path) -> Path | None:
    return run_dir / "metrics.jsonl" if is_coordinator() else None


def _package_dense(
    config: Config,
    run_dir: Path,
    run_name: str,
    packaged: dict[str, torch.Tensor],
    preprocessor: Preprocessor,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    final: dict[str, float],
    register: bool,
    device: torch.device,
    trained_with: str,
) -> tuple[Path, str | None]:
    """The PP and TP tail on the coordinator: the dense family's module
    with the packaged params, a temperature fitted on its validation
    logits, the bulk student of a transformer family, the bundle (its
    ``trained_with`` tag naming the layout) and the registry."""
    if not is_coordinator():
        return run_dir / "bundle", None
    dense_cfg = dataclasses.replace(config.model, pipeline_stages=0, tensor_parallel=0)
    module = load_params(build_model(dense_cfg), packaged).to(device)
    logits = eval_logits(
        module,
        dict(module.named_parameters()),
        torch.from_numpy(valid_ds.cat_ids).to(device),
        torch.from_numpy(valid_ds.numeric).to(device),
    )
    calibration = calibration_record(logits.cpu().numpy(), valid_ds.labels)
    bulk = _maybe_distill(config, module, train_ds, valid_ds, device, model_config=dense_cfg)
    return _package_and_register(
        config,
        run_dir,
        module.cpu(),
        preprocessor,
        train_ds,
        metrics=final,
        bundle_tags={
            "run_name": run_name,
            "experiment": config.registry.experiment_name,
            "trained_with": trained_with,
        },
        registry_tags={
            "run_name": run_name,
            **{k: f"{v:.6f}" for k, v in final.items()},
        },
        register=register,
        calibration=calibration,
        students={"bulk": bulk},
    )


def _run_sharded_loop(
    config: Config,
    run_dir: Path,
    trainer,
    train_ds: EncodedDataset,
    valid_ds: EncodedDataset,
    device: torch.device,
    dense_model: torch.nn.Module,
    packaged_params: Callable[[int], dict[str, torch.Tensor]],
) -> tuple[list[dict], dict[str, float], dict[str, torch.Tensor]]:
    """The PP / TP loop (the JAX package's): seeded batches, an eval of
    the packaged params (the debiased EMA when enabled) every
    ``eval_every`` steps and at the end, checkpoints, resume. Returns the
    history, the final validation metrics and the packaged params (whole,
    on the CPU)."""
    tcfg = config.train
    eval_every, ckpt_every, ckpt_dir, start_step, journal_floor = (
        _layout_run_setup(tcfg, run_dir, trainer)
    )
    cat, num = (torch.from_numpy(a).to(device) for a in (train_ds.cat_ids, train_ds.numeric))
    lab = torch.from_numpy(np.asarray(train_ds.labels, np.float32)).to(device)
    vcat, vnum = (torch.from_numpy(a).to(device) for a in (valid_ds.cat_ids, valid_ds.numeric))
    vlab = torch.from_numpy(np.asarray(valid_ds.labels, np.float32)).to(device)
    history: list[dict] = []
    packaged = None
    with metric_writers(_layout_metrics_path(run_dir), tcfg.tensorboard_dir
                        if is_coordinator() else "") as emit:
        for step in range(start_step + 1, tcfg.steps + 1):
            idx = torch.from_numpy(
                batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, step)
            ).to(device)
            loss = trainer.step(step, cat[idx], num[idx], lab[idx])
            if step % eval_every == 0 or step == tcfg.steps:
                packaged = packaged_params(step)
                record = {
                    "step": step,
                    "loss": round(float(loss), 6),
                    **evaluate(dense_model, packaged, vcat, vnum, vlab),
                }
                if step > journal_floor:  # no duplicate rows on resume
                    emit(record)
                history.append(record)
            _maybe_checkpoint(ckpt_dir, trainer, step, ckpt_every, tcfg.steps)

    def fresh_eval():
        nonlocal packaged
        packaged = packaged_params(start_step)
        return evaluate(dense_model, packaged, vcat, vnum, vlab)

    final = _final_validation_metrics(history, tcfg.steps, fresh_eval)
    return history, final, {k: v.detach().float().cpu() for k, v in packaged.items()}


def _run_tp_training(
    config, run_dir, run_name, preprocessor, train_ds, valid_ds, register, device
) -> PipelineResult:
    """DP x TP (``model.tensor_parallel=K``): the Megatron layout's step,
    then the dense tail. The params are the dense family's tree (TP is a
    layout), so the bundle serves on the exact tier unchanged."""
    from mlops_tpu_torch.train.tensor_parallel import make_tp_trainer

    trainer = make_tp_trainer(config, init_state=load_init_state(config), device=device)
    step = trainer.step
    tcfg = config.train

    def packaged_params(count: int) -> dict[str, torch.Tensor]:
        return step.gather(packaged_or_raw(step.ema, step.params(), tcfg.ema_decay, count))

    history, final, packaged = _run_sharded_loop(
        config, run_dir, step, train_ds, valid_ds, device, trainer.model, packaged_params
    )
    mesh = trainer.mesh
    bundle_dir, model_uri = _package_dense(
        config, run_dir, run_name, packaged, preprocessor, train_ds, valid_ds, final,
        register, device,
        f"tensor_parallel dp{mesh.size('data')}xtp{mesh.size('model')}",
    )
    result = TrainResult(
        params=packaged, metrics=final, history=history, steps=tcfg.steps,
        packaged_step=tcfg.steps,
    )
    return PipelineResult(bundle_dir, model_uri, result, run_dir)


def _run_pp_training(
    config, run_dir, run_name, preprocessor, train_ds, valid_ds, register, device
) -> PipelineResult:
    """DP x PP (``model.pipeline_stages=S``) on a ``('data', 'stage')``
    mesh of the world's ranks; the stages merge into the dense tree for
    the evals and the dense tail."""
    from mlops_tpu_torch.train.pipeline_parallel import make_pp_train_step

    stages = config.model.pipeline_stages
    n_dev = world_size()
    if n_dev % stages:
        raise ValueError(
            f"model.pipeline_stages={stages} needs the device count to be a "
            f"multiple of it; have {n_dev} (launch a multiple of {stages} "
            "ranks: python -m torch.distributed.run --nproc-per-node N)"
        )
    mesh = make_nd_mesh({"data": n_dev // stages, "stage": stages})
    dense_model = build_model(dataclasses.replace(config.model, pipeline_stages=0)).to(device)
    trainer = make_pp_train_step(
        config.model, config.train, mesh, seed=config.train.seed,
        init_state=load_init_state(config), device=device,
    )
    tcfg = config.train

    def packaged_params(count: int) -> dict[str, torch.Tensor]:
        return trainer.dense_params(
            packaged_or_raw(trainer.ema, trainer.params(), tcfg.ema_decay, count)
        )

    history, final, packaged = _run_sharded_loop(
        config, run_dir, trainer, train_ds, valid_ds, device, dense_model, packaged_params
    )
    bundle_dir, model_uri = _package_dense(
        config, run_dir, run_name, packaged, preprocessor, train_ds, valid_ds, final,
        register, device, f"pipeline_parallel dp{mesh.size('data')}xpp{stages}",
    )
    result = TrainResult(
        params=packaged, metrics=final, history=history, steps=tcfg.steps,
        packaged_step=tcfg.steps,
    )
    return PipelineResult(bundle_dir, model_uri, result, run_dir)


def _doc_mesh(config: Config):
    """The doc trainer's ``('data', 'seq')`` mesh under ``seq_parallel``
    (None without): 'seq' is the largest divisor of the world size that
    divides the document length, refused at 1 as in the JAX package."""
    if not config.model.seq_parallel:
        return None
    n_dev = world_size()
    seq = build_doc_model(dataclasses.replace(config.model, seq_parallel=False)).doc_seq_len
    sp = max(
        (d for d in range(1, n_dev + 1) if n_dev % d == 0 and seq % d == 0), default=1
    )
    if sp == 1:
        raise ValueError(
            f"seq_parallel needs the document length (2 + 46*doc_records "
            f"= {seq}) to share a factor with the device count {n_dev}; "
            f"pick doc_records accordingly (11 -> 508 works on 2/4-way)"
        )
    return make_nd_mesh({"data": n_dev // sp, "seq": sp})


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
    mesh = _doc_mesh(config)
    dp = mesh.size("data") if mesh is not None else 1
    # The global batch splits evenly over 'data' (the JAX trainer's rule).
    batch = max(dp, tcfg.batch_size - tcfg.batch_size % dp)
    trainer = make_doc_train_step(
        config.model, tcfg, mesh=mesh, seed=tcfg.seed, device=device
    )
    dcat, dnum, dlab = (
        torch.from_numpy(a).to(device) for a in make_documents(train_ds, r)
    )
    vcat, vnum, vlab = make_documents(valid_ds, r)
    vcat_d, vnum_d = torch.from_numpy(vcat).to(device), torch.from_numpy(vnum).to(device)

    def valid_doc_logits(params: dict[str, torch.Tensor]) -> torch.Tensor:
        return trainer.eval_logits(params, vcat_d, vnum_d, EVAL_CHUNK)

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
    with metric_writers(_layout_metrics_path(run_dir), tcfg.tensorboard_dir
                        if is_coordinator() else "") as emit:
        for step in range(start_step + 1, tcfg.steps + 1):
            idx = torch.from_numpy(
                batch_indices(dcat.shape[0], batch, tcfg.seed, step)
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
    if is_coordinator():
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
    dense_cfg = dataclasses.replace(config.model, seq_parallel=False)
    bundle_dir, model_uri = _package_and_register(
        config,
        run_dir,
        load_params(build_doc_model(dense_cfg), params_host),
        preprocessor,
        train_ds,
        metrics=final,
        bundle_tags={
            "run_name": run_name or run_dir.name,
            "experiment": config.registry.experiment_name,
            "trained_with": (
                f"long_context dp{dp}xsp{mesh.size('seq')}" if mesh is not None
                else "long_context dense"
            ),
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
    config: Config, register: bool = True, run_name: str | None = None, mesh=None
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
    not read, as in the JAX package. With ``mesh`` (the ``tune`` command's
    data mesh when the world has more than one rank) the trials split
    over its 'data' axis; the coordinator writes the run directory, the
    records and the bundle, and every rank returns the same result."""
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
    device = rank_device(config.train.device)
    run_name = broadcast_object(run_name or time.strftime("%Y%m%d-%H%M%S") + "-tune")
    coord = is_coordinator()
    run_dir = (
        new_run_dir(config, run_name) if coord
        else Path(config.registry.run_root) / run_name
    )
    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, config.data.valid_fraction)
    t0 = time.perf_counter()
    win_model, hpo_result = run_architecture_hpo(
        model, config.train, config.hpo, train_ds, valid_ds,
        device=device, resume_dir=run_dir, mesh=mesh,
    )
    logging.getLogger(__name__).info(
        "tune: %d trials swept in %.3f s on %s",
        len(hpo_result.trials), time.perf_counter() - t0, device,
    )
    result = PipelineResult(
        bundle_dir=run_dir / "bundle",
        model_uri=None,
        train_result=TrainResult(
            params=hpo_result.best_params,
            metrics=hpo_result.best_metrics,
            history=[],
            steps=config.hpo.steps,
        ),
        run_dir=run_dir,
    )
    if not coord:
        result.model_uri = broadcast_object(None)
        return result, hpo_result
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
    result.bundle_dir = bundle_dir
    result.model_uri = broadcast_object(model_uri)
    return result, hpo_result
