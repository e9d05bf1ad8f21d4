"""Configuration: the ported subset of the JAX package's config tree.

``ModelConfig`` and ``TrainConfig`` are copies of the JAX dataclasses,
field for field with their defaults, so a bundle manifest's
``model_config`` and a job's TOML parse into them. ``data``,
``monitor`` and ``registry`` hold the fields the ported paths read;
``serve`` the subset of ``ServeConfig`` the exact and quant tiers read. Two port-only knobs,
``serve.device`` and ``train.device``, say where the entry points run:
the card unless the caller writes ``cpu``.

``load_config`` builds the tree as the JAX package's does: defaults <-
TOML (``--config <file>``) <- positional ``section.field=value``
overrides (``train.steps=200``, ``serve.port=5001``). The JAX package's
``MLOPS_TPU_<SECTION>_<FIELD>`` environment overrides are not ported yet.
"""

from __future__ import annotations

import dataclasses
import tomllib
import typing
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class DataConfig:
    train_path: str = ""  # train: CSV to train on (empty -> synthetic);
    # predict-file: the history CSV to score
    rows: int = 50_000  # synthetic row count
    seed: int = 0
    valid_fraction: float = 0.2  # held-out split (seed 2024)


@dataclasses.dataclass
class ModelConfig:
    """The JAX package's ``ModelConfig`` (``mlops_tpu/config.py:42``),
    field for field with its defaults. The port builds the exact tier's
    linear, mlp and deep-ensemble models (``models.build_model``) and the
    dense doc model (``family="bert"``, ``doc_records > 1``) from it."""

    family: str = "mlp"  # mlp | ft_transformer | moe | linear | bert | gbm | rf
    hidden_dims: tuple[int, ...] = (256, 256, 128)
    embed_dim: int = 16
    dropout: float = 0.1
    precision: str = "bf16"  # compute dtype: bf16 | f32 (params stay f32)
    ensemble_size: int = 1
    depth: int = 3
    heads: int = 8
    token_dim: int = 64
    num_experts: int = 8
    n_estimators: int = 300
    max_tree_depth: int = 8
    doc_records: int = 1  # >1: one document of doc_records records
    # (seq = 2 + 46R tokens), the long-context doc model
    seq_parallel: bool = False  # ring attention over a 'seq' mesh axis
    pipeline_stages: int = 0
    tensor_parallel: int = 0

    @property
    def uses_layout_trainer(self) -> bool:
        """True when this config trains through a layout trainer (the
        doc model, pipeline or tensor parallel) instead of the dense
        single-record ``run_training``: the JAX package's predicate."""
        return bool(
            self.pipeline_stages
            or self.seq_parallel
            or self.doc_records > 1
            or self.tensor_parallel
        )


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (``mlops_tpu/config.py:98``),
    field for field, plus ``device``. The dense trainer reads what the JAX
    ``fit`` reads (warmup_steps and keep_best too; the pipeline-parallel
    knobs are not its); the doc trainer reads batch_size, steps,
    learning_rate, weight_decay, seed, eval_every, checkpoint_every,
    pos_weight and ema_decay, as the JAX doc trainer does.
    tensorboard_dir, init_params, distill_quant and (for ensembles and
    transformers) distill_bulk are refused when set."""

    batch_size: int = 1024
    steps: int = 2000
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    seed: int = 0
    eval_every: int = 200
    checkpoint_every: int = 500
    pos_weight: float = 1.0
    init_params: str = ""
    tensorboard_dir: str = ""
    keep_best: bool = True
    distill_bulk: bool = True
    distill_quant: bool = False
    pipeline_microbatches: int = 8
    pipeline_remat: bool = False
    ema_decay: float = 0.0
    device: str = "cuda"  # "cpu" trains on the CPU (the plain torch route)


@dataclasses.dataclass
class MonitorConfig:
    outlier_quantile: float = 0.95
    drift_ref_size: int = 2048  # per-feature reference sample for K-S


@dataclasses.dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 5000
    service_name: str = "credit-default-api"
    model_directory: str = "model"  # a bundle directory
    max_batch: int = 256  # request-size cap (413 above it), clamped to the
    # largest warmed bucket so serving never pads past the bucket grid;
    # predict-file: documents per forward chunk
    warmup_batch_sizes: tuple[int, ...] = (1, 8, 64, 256)
    serve_tier: str = "exact"  # exact | quant | auto, as in the JAX package
    model_shards: int = 1  # as in the JAX package; load_config refuses >1
    device: str = "cuda"  # "cpu" runs on the CPU (plain torch route)
    max_workers: int = 8  # scoring thread pool size
    drain_deadline_s: float = 30.0  # SIGTERM: how long busy exchanges may
    # take to finish their response before connections are force-closed


@dataclasses.dataclass
class RegistryConfig:
    root: str = "registry"  # a local directory (gs:// is not ported)
    model_name: str = "credit-default-uci-custom"
    experiment_name: str = "credit-default-uci-train"
    run_root: str = "runs"  # per-run artifacts: metrics.jsonl, checkpoints
    run_name: str = ""  # stable run-directory name: a rerun with the same
    # name resumes from its checkpoints; empty = a fresh timestamped one


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    monitor: MonitorConfig = dataclasses.field(default_factory=MonitorConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    registry: RegistryConfig = dataclasses.field(default_factory=RegistryConfig)


def _coerce(owner: type, field: str, current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        args = typing.get_args(typing.get_type_hints(owner)[field])
        inner = args[0] if args else str
        body = raw.strip("()[] ")
        return tuple(inner(x) for x in body.split(",") if x.strip())
    return raw


def _apply(config: Config, section: str, field: str, value: Any) -> None:
    sub = getattr(config, section, None)
    if sub is None or not hasattr(sub, field):
        raise KeyError(
            f"unknown config key {section}.{field} (this package has not "
            "ported it, or it does not exist)"
        )
    current = getattr(sub, field)
    if isinstance(value, str) and not isinstance(current, str):
        value = _coerce(type(sub), field, current, value)
    elif isinstance(current, tuple) and isinstance(value, list):
        value = tuple(value)
    elif isinstance(current, float) and isinstance(value, int):
        value = float(value)
    setattr(sub, field, value)


def load_config(
    overrides: list[str] | None = None, toml_path: str | Path | None = None
) -> Config:
    """Defaults <- TOML (``toml_path``) <- ``section.field=value``
    overrides. Unknown keys raise, except a TOML's ``[hpo]`` table, which
    configures the ``tune`` command (not ported, ROADMAP A6) and is
    skipped so a job file of both commands trains."""
    config = Config()
    if toml_path:
        with open(toml_path, "rb") as f:
            doc = tomllib.load(f)
        for section, fields in doc.items():
            if section == "hpo":
                continue
            for field, value in fields.items():
                _apply(config, section, field, value)
    for item in overrides or []:
        key, sep, raw = item.partition("=")
        section, _, field = key.strip("-").partition(".")
        if not sep:
            raise KeyError(f"unknown config override {item!r}")
        _apply(config, section, field, raw)
    if config.serve.model_shards != 1:
        raise ValueError(
            f"serve.model_shards={config.serve.model_shards} refused: sharding "
            "the exact params over several cards is not ported (ROADMAP A11)"
        )
    return config
