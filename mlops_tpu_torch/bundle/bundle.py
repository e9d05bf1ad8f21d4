"""Quant-tier bundle load and save, in the JAX package's on-disk format.

A bundle is one directory: ``manifest.json``, ``preprocess.npz``,
``monitor.npz`` and, for the quant tier, ``quant_params.npz`` plus the
manifest's ``quant`` block (format tag, fidelity, refit temperature and
the stamped promotion-gate decision). The port serves only the quant tier
in this slice, so it never reads the exact tier's ``params.msgpack``.
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
from mlops_tpu_torch.data.encode import Preprocessor
from mlops_tpu_torch.monitor.state import MonitorState
from mlops_tpu_torch.ops.quant import (
    QUANT_FORMAT,
    quant_params_from_arrays,
    quant_params_to_arrays,
)
from mlops_tpu_torch.schema.features import SCHEMA

MANIFEST_NAME = "manifest.json"
QUANT_PARAMS_NAME = "quant_params.npz"
PREPROCESS_NAME = "preprocess.npz"
MONITOR_NAME = "monitor.npz"


@dataclasses.dataclass
class Bundle:
    """A loaded bundle: fitted state on the CPU, ready for an engine."""

    manifest: dict[str, Any]
    preprocessor: Preprocessor
    monitor: MonitorState
    quant_params: dict[str, torch.Tensor] | None = None

    @property
    def flavor(self) -> str:
        return self.manifest.get("flavor", "flax")

    @property
    def has_quant(self) -> bool:
        return self.quant_params is not None

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


def load_bundle(directory: str | Path) -> Bundle:
    """Load a bundle directory. Refuses a schema fingerprint other than
    this package's and a quant blob in a foreign packing format."""
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
    )


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
        "framework": {
            "mlops_tpu_torch": __version__,
            "torch": torch.__version__,
            "numpy": np.__version__,
        },
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
