"""Serving configuration: the quant-tier subset of the JAX package's
``ServeConfig``, with positional ``section.field=value`` overrides parsed
the same way (``serve.port=5001``)."""

from __future__ import annotations

import dataclasses
import typing
from typing import Any


@dataclasses.dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 5000
    service_name: str = "credit-default-api"
    model_directory: str = "model"  # a bundle directory
    max_batch: int = 256  # request-size cap (413 above it), clamped to the
    # largest warmed bucket so serving never pads past the bucket grid
    warmup_batch_sizes: tuple[int, ...] = (1, 8, 64, 256)
    serve_tier: str = "quant"  # the only tier this package serves yet
    device: str = "cuda"  # "cpu" serves on the CPU (plain torch route)
    max_workers: int = 8  # scoring thread pool size
    drain_deadline_s: float = 30.0  # SIGTERM: how long busy exchanges may
    # take to finish their response before connections are force-closed


@dataclasses.dataclass
class Config:
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
