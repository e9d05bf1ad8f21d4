"""Bundle load and save, in the JAX package's on-disk format.

A bundle is one directory: ``manifest.json``, ``preprocess.npz``,
``monitor.npz`` and, by flavor and tier:

- the exact tier of a ``flax`` bundle: ``params.msgpack`` (flax's
  serialization, read and written by ``bundle.msgpack``) and the
  manifest's ``model_config``, from which ``models.build_model`` builds
  the module of any family of the zoo or a deep ensemble of it; a family
  the port does not build loads without it (``Bundle.exact_refusal``
  says why);
- the bulk tier (the distilled student of an ensemble or a transformer
  family, ``train/distill.py distill_for_bulk``): ``bulk_params.msgpack``
  plus the manifest's ``bulk`` block (the student's ``model_config`` and
  its fidelity record); ``parallel/bulk.py`` routes bulk sweeps through
  it;
- the quant tier: ``quant_params.npz`` plus the manifest's ``quant``
  block (format tag, fidelity, refit temperature and the stamped
  promotion-gate decision); a bundle trained with
  ``train.distill_quant=true`` carries it beside the exact tier;
- the ``doc`` flavor (the long-context document model): ``params.msgpack``
  and the manifest's ``model_config``, from which the dense doc model is
  built;
- the ``sklearn`` flavor (the gbm and rf tree-ensemble floor): the JAX
  package's ``estimator.joblib`` and, for a HistGBM ensemble, the port's
  tree file ``gbm_tensor.npz`` (``ops/gbm_tensor.py``), which numpy alone
  reads. The JAX loader ignores the extra file, so these bundles cross in
  both directions; a gbm bundle without the tree file (a JAX-written one)
  is extracted from its estimator at load. Where scikit-learn or joblib
  does not import (the card's machine) the tree file serves alone.
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
ESTIMATOR_NAME = "estimator.joblib"
GBM_TENSOR_NAME = "gbm_tensor.npz"
PARAMS_NAME = "params.msgpack"
BULK_PARAMS_NAME = "bulk_params.msgpack"
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
    # flax flavor: the exact tier's module; doc flavor: BertDocEncoder
    model: torch.nn.Module | None = None
    exact_refusal: str = ""  # why a flax bundle loaded without its exact tier
    bulk_model: torch.nn.Module | None = None  # the distilled bulk student
    # sklearn flavor: the fitted ensemble (``models.gbm.SklearnBaseline``;
    # None where scikit-learn does not import) and, for a HistGBM one, its
    # tree arrays and geometry (``ops/gbm_tensor.py``), which the gbm tier
    # serves.
    estimator: Any = None
    gbm_tensor: tuple[dict[str, np.ndarray], Any] | None = None

    @property
    def has_bulk(self) -> bool:
        """True when the bundle carries a distilled bulk student (bulk
        sweeps may route through it; serving always uses the exact
        model)."""
        return self.bulk_model is not None

    @property
    def bulk_variables(self) -> dict[str, torch.Tensor] | None:
        """The bulk student's parameters by flattened flax name."""
        if self.bulk_model is None:
            return None
        return dict(self.bulk_model.state_dict())

    @property
    def bulk_fidelity(self) -> dict[str, float]:
        return dict(self.manifest.get("bulk", {}).get("fidelity", {}))

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


def _load_weights(
    model: torch.nn.Module, directory: Path, name: str, family: str
) -> torch.nn.Module:
    """``model`` with its weights from the flax tree in ``directory /
    name``, checked against the module's tree and shapes."""
    from mlops_tpu_torch.weights import exact_params_from_numpy, load_params

    tree = msgpack.unpackb((directory / name).read_bytes())
    try:
        load_params(model, exact_params_from_numpy(tree, "cpu"))
    except ValueError as err:
        raise ValueError(
            f"bundle {directory} holds a param tree ({name}) that no longer "
            f"matches the {family!r} module this package builds — "
            "re-train/re-register the model"
        ) from err
    return model.eval()


def _load_exact_model(
    directory: Path, manifest: dict[str, Any]
) -> tuple[torch.nn.Module | None, str]:
    """The exact tier's module of a ``flax`` bundle with its weights from
    ``params.msgpack``, or ``(None, why)`` when the bundle has no exact
    params or its family is not one the port builds."""
    from mlops_tpu_torch.models import build_model

    if not (directory / PARAMS_NAME).exists() or not manifest.get("model_config"):
        return None, "bundle carries no exact-tier params (params.msgpack)"
    config = _model_config_from_manifest(manifest)
    try:
        model = build_model(config)
    except ValueError as err:
        return None, str(err)
    return _load_weights(model, directory, PARAMS_NAME, config.family), ""


def _sklearn_imports() -> bool:
    """scikit-learn and joblib both import here."""
    try:
        import joblib  # noqa: F401
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def _load_sklearn(directory: Path) -> tuple[Any, Any]:
    """An sklearn bundle's ``(estimator, gbm_tensor)``: the estimator where
    scikit-learn and joblib import, the tree file where the bundle has one
    (else extracted from a tensorizable estimator). Raises when neither
    can be had."""
    from mlops_tpu_torch.models.gbm import SklearnBaseline
    from mlops_tpu_torch.ops.gbm_tensor import (
        extract_gbm,
        load_gbm_tensor,
        supports_gbm_tensorization,
    )

    estimator = None
    if (directory / ESTIMATOR_NAME).exists() and _sklearn_imports():
        estimator = SklearnBaseline.load(directory / ESTIMATOR_NAME)
    if (directory / GBM_TENSOR_NAME).exists():
        return estimator, load_gbm_tensor(directory / GBM_TENSOR_NAME)
    if estimator is not None:
        tensor = extract_gbm(estimator) if supports_gbm_tensorization(estimator) else None
        return estimator, tensor
    if (directory / ESTIMATOR_NAME).exists():
        raise ValueError(
            f"bundle {directory} is an sklearn bundle without {GBM_TENSOR_NAME}: "
            f"its {ESTIMATOR_NAME} needs scikit-learn and joblib, which do not "
            "import here"
        )
    raise ValueError(
        f"bundle {directory} is an sklearn bundle with neither {ESTIMATOR_NAME} "
        f"nor {GBM_TENSOR_NAME}"
    )


def load_bundle(directory: str | Path) -> Bundle:
    """Load a bundle directory. Refuses a schema fingerprint other than
    this package's, a quant blob in a foreign packing format and a param
    tree that does not match its module."""
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
    model, exact_refusal = None, ""
    estimator = gbm_tensor = None
    if manifest.get("flavor") == "sklearn":
        estimator, gbm_tensor = _load_sklearn(directory)
    elif manifest.get("flavor") == "doc":
        model = _load_doc_model(directory, manifest)
    elif manifest.get("flavor", "flax") == "flax":
        model, exact_refusal = _load_exact_model(directory, manifest)
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
    bulk_model = None
    if "bulk" in manifest and (directory / BULK_PARAMS_NAME).exists():
        from mlops_tpu_torch.models import build_model

        bulk_config = _model_config_from_manifest(manifest["bulk"])
        bulk_model = _load_weights(
            build_model(bulk_config), directory, BULK_PARAMS_NAME, bulk_config.family
        )
    return Bundle(
        manifest=manifest,
        preprocessor=preprocessor,
        monitor=monitor,
        quant_params=quant_params,
        model=model,
        exact_refusal=exact_refusal,
        bulk_model=bulk_model,
        estimator=estimator,
        gbm_tensor=gbm_tensor,
    )


def _framework(flavor: str = "flax") -> dict[str, str]:
    """The runtime versions the bundle's behaviour depends on; an sklearn
    bundle pins scikit-learn and joblib too, as the JAX package does,
    where they are installed."""
    import importlib.metadata

    pins = {
        "mlops_tpu_torch": __version__,
        "torch": torch.__version__,
        "numpy": np.__version__,
    }
    if flavor == "sklearn":
        for package in ("scikit-learn", "joblib"):
            try:
                pins[package] = importlib.metadata.version(package)
            except importlib.metadata.PackageNotFoundError:
                pass  # not installed here: nothing to pin
    return pins


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


def save_exact_bundle(
    directory: str | Path,
    model_config: ModelConfig,
    model: torch.nn.Module,
    preprocessor: Preprocessor,
    monitor: MonitorState,
    calibration: dict[str, float] | None = None,
    tags: dict[str, str] | None = None,
    metrics: dict[str, float] | None = None,
    quant_params: dict[str, torch.Tensor] | None = None,
    quant: dict[str, Any] | None = None,
    bulk: Any = None,
) -> Path:
    """Write a ``flax`` bundle of the exact tier that the JAX package's
    ``load_bundle`` reads: the manifest with its ``model_config``,
    ``metrics``, ``tags`` and ``calibration``, the module's weights as
    flax's ``params.msgpack`` (f32, keys in flax's order, the ensemble's
    member axis leading), and the two npz files. With ``quant_params``
    the bundle carries the quant tier too (``quant``: its manifest block,
    fidelity, refit temperature and stamped gates); with ``bulk`` (a
    ``train.distill.DistillResult``) the distilled bulk student, as
    ``bulk_params.msgpack`` and the manifest's ``bulk`` block."""
    from mlops_tpu_torch.weights import unflatten_tree

    if model_config.doc_records > 1:
        raise ValueError("a doc model (doc_records > 1) is a doc bundle")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {
        "format_version": 1,
        "flavor": "flax",
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
    if bulk is not None:
        manifest["bulk"] = {
            "model_config": dataclasses.asdict(bulk.student_config),
            "fidelity": bulk.fidelity,
        }
        student = {k: v.detach().cpu().float() for k, v in bulk.student_params.items()}
        (directory / BULK_PARAMS_NAME).write_bytes(
            msgpack.packb(unflatten_tree(student))
        )
    if quant_params is not None:
        manifest["quant"] = {"format": QUANT_FORMAT, **(quant or {})}
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


def save_sklearn_bundle(
    directory: str | Path,
    model_config: ModelConfig,
    preprocessor: Preprocessor,
    monitor: MonitorState,
    estimator: Any = None,
    gbm_tensor: tuple[dict[str, np.ndarray], Any] | None = None,
    calibration: dict[str, float] | None = None,
    tags: dict[str, str] | None = None,
    metrics: dict[str, float] | None = None,
) -> Path:
    """Write an ``sklearn`` bundle: the manifest (the JAX ``save_bundle``'s
    keys), ``estimator.joblib`` as the JAX package writes it when
    ``estimator`` (a ``SklearnBaseline``) is given, the tree file for a
    HistGBM ensemble (``gbm_tensor``, else extracted from a tensorizable
    estimator) and the two npz files. A bundle with the tree file alone
    serves the gbm tier without scikit-learn; only the port loads it."""
    from mlops_tpu_torch.ops.gbm_tensor import (
        extract_gbm,
        save_gbm_tensor,
        supports_gbm_tensorization,
    )

    if estimator is None and gbm_tensor is None:
        raise ValueError("an sklearn bundle needs an estimator or gbm tree arrays")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {
        "format_version": 1,
        "flavor": "sklearn",
        "framework": _framework("sklearn"),
        "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "schema_fingerprint": SCHEMA.fingerprint(),
        "model_config": dataclasses.asdict(model_config),
        "metrics": metrics or {},
        "tags": tags or {},
        "calibration": calibration or {},
    }
    if estimator is not None:
        estimator.save(directory / ESTIMATOR_NAME)
        if gbm_tensor is None and supports_gbm_tensorization(estimator):
            gbm_tensor = extract_gbm(estimator)
    if gbm_tensor is not None:
        save_gbm_tensor(directory / GBM_TENSOR_NAME, *gbm_tensor)
    preprocessor.save(directory / PREPROCESS_NAME)
    monitor.save(directory / MONITOR_NAME)
    (directory / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return directory
