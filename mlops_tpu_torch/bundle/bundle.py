"""Bundle load and save, in the JAX package's on-disk format.

A bundle is one directory: ``manifest.json``, ``preprocess.npz``,
``monitor.npz`` and, by flavor and tier:

- the quant tier: ``quant_params.npz`` plus the manifest's ``quant``
  block (format tag, fidelity, refit temperature and the stamped
  promotion-gate decision);
- the ``doc`` flavor (the long-context document model): ``params.msgpack``
  (flax's serialization, read and written by ``bundle.msgpack``) and the
  manifest's ``model_config``, from which the dense doc model is built.

The exact tier's ``params.msgpack`` of a ``flax`` bundle is not read yet:
its models are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mlops_tpu_torch import __version__
from mlops_tpu_torch.bundle import msgpack
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data.encode import Preprocessor
from mlops_tpu_torch.monitor.state import MonitorState
from mlops_tpu_torch.ops.quant import (
    QUANT_FORMAT,
    quant_params_from_arrays,
    quant_params_to_arrays,
)
from mlops_tpu_torch.schema.features import SCHEMA

MANIFEST_NAME = "manifest.json"
PARAMS_NAME = "params.msgpack"
QUANT_PARAMS_NAME = "quant_params.npz"
PREPROCESS_NAME = "preprocess.npz"
MONITOR_NAME = "monitor.npz"


@dataclasses.dataclass
class Bundle:
    """A loaded bundle: fitted state on the CPU, ready for an engine (or,
    for the ``doc`` flavor, the doc model with its weights, on the CPU)."""

    manifest: dict[str, Any]
    preprocessor: Preprocessor
    monitor: MonitorState
    quant_params: dict[str, torch.Tensor] | None = None
    model: torch.nn.Module | None = None  # doc flavor: BertDocEncoder

    @property
    def flavor(self) -> str:
        return self.manifest.get("flavor", "flax")

    @property
    def has_quant(self) -> bool:
        return self.quant_params is not None

    @property
    def model_config(self) -> ModelConfig:
        return _model_config_from_manifest(self.manifest)

    @property
    def temperature(self) -> float:
        """The exact tier's calibration temperature (1.0 when absent)."""
        return float(self.manifest.get("calibration", {}).get("temperature", 1.0))

    @property
    def quant_temperature(self) -> float:
        """The quant tier's refit temperature; falls back to the exact
        tier's for old manifests."""
        quant = self.manifest.get("quant", {})
        return float(quant.get("temperature", self.temperature))

    @property
    def quant_gates_passed(self) -> bool:
        """The stamped packaging-time promotion decision. An absent block
        or decision grades as failed: an ungraded tier must not serve."""
        return bool(
            self.manifest.get("quant", {}).get("gates", {}).get("passed", False)
        )


def _model_config_from_manifest(manifest: dict[str, Any]) -> ModelConfig:
    """JSON lists -> tuples so manifests round-trip to equal ModelConfigs."""
    return ModelConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in manifest["model_config"].items()
    })


def _load_doc_model(directory: Path, manifest: dict[str, Any]) -> torch.nn.Module:
    """The dense doc model of the manifest's ``model_config`` (the ring is
    a training-time layout), its weights from ``params.msgpack``."""
    from mlops_tpu_torch.train.long_context import build_doc_model
    from mlops_tpu_torch.weights import doc_params_from_numpy, load_params

    config = dataclasses.replace(
        _model_config_from_manifest(manifest), seq_parallel=False
    )
    model = build_doc_model(config)
    tree = msgpack.unpackb((directory / PARAMS_NAME).read_bytes())
    try:
        load_params(model, doc_params_from_numpy(tree, "cpu"))
    except ValueError as err:
        raise ValueError(
            f"bundle {directory} holds a param tree that no longer matches "
            f"the {config.family!r} doc module this package builds — "
            "re-train/re-register the model"
        ) from err
    return model.eval()


def load_bundle(directory: str | Path) -> Bundle:
    """Load a bundle directory. Refuses a schema fingerprint other than
    this package's, a quant blob in a foreign packing format and a doc
    param tree that does not match the module."""
    directory = Path(directory)
    manifest = json.loads((directory / MANIFEST_NAME).read_text())
    if manifest["schema_fingerprint"] != SCHEMA.fingerprint():
        raise ValueError(
            f"bundle {directory} was built for schema "
            f"{manifest['schema_fingerprint']}, runtime schema is "
            f"{SCHEMA.fingerprint()}"
        )
    preprocessor = Preprocessor.load(directory / PREPROCESS_NAME)
    monitor = MonitorState.load(directory / MONITOR_NAME)
    model = None
    if manifest.get("flavor") == "doc":
        model = _load_doc_model(directory, manifest)
    quant_params = None
    if "quant" in manifest and (directory / QUANT_PARAMS_NAME).exists():
        stored = manifest["quant"].get("format")
        if stored != QUANT_FORMAT:
            raise ValueError(
                f"bundle {directory} carries quant params in format "
                f"{stored!r}; this framework serves {QUANT_FORMAT!r} — "
                "re-run packaging to regenerate the quant tier"
            )
        with np.load(directory / QUANT_PARAMS_NAME) as data:
            quant_params = quant_params_from_arrays(
                {k: data[k] for k in data.files}
            )
    return Bundle(
        manifest=manifest,
        preprocessor=preprocessor,
        monitor=monitor,
        quant_params=quant_params,
        model=model,
    )


def _framework() -> dict[str, str]:
    return {
        "mlops_tpu_torch": __version__,
        "torch": torch.__version__,
        "numpy": np.__version__,
    }


def save_quant_bundle(
    directory: str | Path,
    preprocessor: Preprocessor,
    monitor: MonitorState,
    quant_params: dict[str, torch.Tensor],
    temperature: float = 1.0,
    gates: dict[str, Any] | None = None,
    tags: dict[str, str] | None = None,
) -> Path:
    """Write a quant-tier bundle: the manifest and the three npz files in
    the JAX package's layout (no exact-tier ``params.msgpack``)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {
        "format_version": 1,
        "flavor": "flax",
        "framework": _framework(),
        "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "schema_fingerprint": SCHEMA.fingerprint(),
        "model_config": {},
        "metrics": {},
        "tags": tags or {},
        "calibration": {},
        "quant": {
            "format": QUANT_FORMAT,
            "fidelity": {},
            "temperature": float(temperature),
            "gates": gates or {},
        },
    }
    np.savez(
        directory / QUANT_PARAMS_NAME, **quant_params_to_arrays(quant_params)
    )
    preprocessor.save(directory / PREPROCESS_NAME)
    monitor.save(directory / MONITOR_NAME)
    (directory / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return directory


def save_doc_bundle(
    directory: str | Path,
    model_config: ModelConfig,
    model: torch.nn.Module,
    preprocessor: Preprocessor,
    monitor: MonitorState,
    calibration: dict[str, float] | None = None,
    tags: dict[str, str] | None = None,
    metrics: dict[str, float] | None = None,
) -> Path:
    """Write a ``doc`` bundle the JAX package loads: the manifest with its
    ``model_config``, ``metrics``, ``tags`` and ``calibration`` (as the
    JAX ``save_bundle`` writes them), the model's weights as flax's
    ``params.msgpack`` (f32, keys in flax's order) and the two npz
    files."""
    from mlops_tpu_torch.weights import unflatten_tree

    if model_config.doc_records <= 1:
        raise ValueError("a doc bundle needs model_config.doc_records > 1")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {
        "format_version": 1,
        "flavor": "doc",
        "framework": _framework(),
        "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "schema_fingerprint": SCHEMA.fingerprint(),
        "model_config": dataclasses.asdict(model_config),
        "metrics": metrics or {},
        "tags": tags or {},
        "calibration": calibration or {},
    }
    params = {k: v.detach().cpu().float() for k, v in model.state_dict().items()}
    (directory / PARAMS_NAME).write_bytes(msgpack.packb(unflatten_tree(params)))
    preprocessor.save(directory / PREPROCESS_NAME)
    monitor.save(directory / MONITOR_NAME)
    (directory / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return directory
