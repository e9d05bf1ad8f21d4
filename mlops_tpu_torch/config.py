"""Configuration: the ported subset of the JAX package's config tree.

``serve`` holds the quant-tier subset of ``ServeConfig`` (plus the
``device`` knob), ``data`` the input path of ``predict-file``.
``ModelConfig`` is a copy of the JAX dataclass, field for field, so a
bundle manifest's ``model_config`` parses into it. Overrides are
positional ``section.field=value`` pairs, parsed the JAX package's way
(``serve.port=5001``, ``data.train_path=<csv>``)."""

from __future__ import annotations

import dataclasses
import typing
from typing import Any


@dataclasses.dataclass
class DataConfig:
    train_path: str = ""  # predict-file: the history CSV to score


@dataclasses.dataclass
class ModelConfig:
    """The JAX package's ``ModelConfig`` (``mlops_tpu/config.py:42``),
    field for field with its defaults. The port builds only the dense doc
    model from it so far (``family="bert"``, ``doc_records > 1``)."""

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
    serve_tier: str = "quant"  # the only tier this package serves yet
    device: str = "cuda"  # "cpu" runs on the CPU (plain torch route)
    max_workers: int = 8  # scoring thread pool size
    drain_deadline_s: float = 30.0  # SIGTERM: how long busy exchanges may
    # take to finish their response before connections are force-closed


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)


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


def load_config(overrides: list[str] | None = None) -> Config:
    """Defaults <- ``section.field=value`` overrides. Unknown keys raise."""
    config = Config()
    for item in overrides or []:
        key, sep, raw = item.partition("=")
        section, _, field = key.strip("-").partition(".")
        sub = getattr(config, section, None)
        if not sep or sub is None or not hasattr(sub, field):
            raise KeyError(f"unknown config override {item!r}")
        current = getattr(sub, field)
        setattr(sub, field, _coerce(type(sub), field, current, raw))
    return config
