"""The gbm tier's fixture: the job's HistGBM ensemble as tree arrays, for
a machine without scikit-learn.

``write_fixture`` runs the port's own ``train --config
configs/train_register_job.toml model.family=gbm`` on the CPU (the job's
seed and data: 50,000 synthetic rows, 40,000 to train; scikit-learn's
early stopping sets the tree count) and writes one npz,
``tests/fixtures/torch_gbm/job_gbm.npz``, holding

- the tree arrays, their geometry and the format tag, in the layout of
  the bundle's tree file (``ops/gbm_tensor.py load_gbm_tensor`` reads
  the fixture as it is);
- the calibration temperature (``temperature``);
- the first ``ROWS`` encoded validation rows (``cat_ids``, ``numeric``)
  with scikit-learn's probabilities for them (``proba``) and the tempered
  ones the served bundle answers (``probs``);
- the scikit-learn version that fitted the trees (``sklearn_version``).

``fixture_bundle`` builds the served bundle from the fixture with numpy
and torch alone: the preprocessor and monitor the port fits from its own
synthetic data at the job's seed (what the training run fitted), and the
fixture's trees and temperature. ``chip_smoke.py`` serves it on the card,
where scikit-learn is not installed; ``tests/test_torch_gbm.py`` checks
that a fresh ``write_fixture`` gives the committed arrays bit for bit.

Run from the repository root (needs scikit-learn):

    python scripts/torch_gbm_fixture.py [out.npz]
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
JOB = ROOT / "configs" / "train_register_job.toml"
FIXTURE = ROOT / "tests" / "fixtures" / "torch_gbm" / "job_gbm.npz"
ROWS = 2048  # validation rows recorded with their probabilities


def job_config(work: Path, device: str = "cpu"):
    """The job's config with the gbm family, its registry under ``work``."""
    from mlops_tpu_torch.config import load_config

    return load_config(
        ["model.family=gbm", f"train.device={device}",
         f"registry.root={work / 'registry'}", f"registry.run_root={work / 'runs'}",
         "registry.run_name=gbm-fixture"],
        JOB,
    )


def _split(config):
    """The preprocessor and the (train, valid) split ``run_training`` makes."""
    from mlops_tpu_torch.data import Preprocessor
    from mlops_tpu_torch.train.pipeline import load_training_data, split_dataset

    columns, labels = load_training_data(config)
    preprocessor = Preprocessor.fit(columns)
    train_ds, valid_ds = split_dataset(preprocessor.encode(columns, labels),
                                       config.data.valid_fraction)
    return preprocessor, train_ds, valid_ds


def fixture_arrays(work: Path) -> dict[str, np.ndarray]:
    """Train the job's gbm model under ``work`` and return the fixture's
    arrays (needs scikit-learn)."""
    import sklearn

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.gbm_tensor import GBM_FIELDS, GBM_FORMAT
    from mlops_tpu_torch.train.calibrate import apply_temperature
    from mlops_tpu_torch.train.pipeline import run_training

    config = job_config(work)
    result = run_training(config, register=False)
    bundle = load_bundle(result.bundle_dir)
    _, _, valid_ds = _split(config)
    cat, num = valid_ds.cat_ids[:ROWS], valid_ds.numeric[:ROWS]
    proba = bundle.estimator.predict_proba(cat, num)
    variables, geometry = bundle.gbm_tensor
    return {
        **{k: np.asarray(variables[k]) for k in GBM_FIELDS},
        "format": np.array(GBM_FORMAT),
        "n_trees": np.int64(geometry.n_trees),
        "max_nodes": np.int64(geometry.max_nodes),
        "depth": np.int64(geometry.depth),
        "temperature": np.float64(bundle.temperature),
        "cat_ids": cat,
        "numeric": num,
        "proba": proba,
        "probs": apply_temperature(proba, bundle.temperature).astype(np.float32),
        "sklearn_version": np.array(sklearn.__version__),
    }


def write_fixture(out: Path = FIXTURE) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        arrays = fixture_arrays(Path(work))
    np.savez_compressed(out, **arrays)
    return out


def read_fixture(path: Path = FIXTURE) -> dict[str, np.ndarray]:
    """Every array of the fixture, by name."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def fixture_bundle(directory: Path, fixture: Path = FIXTURE) -> Path:
    """Write the served gbm bundle of the fixture to ``directory`` with
    numpy and torch alone: the preprocessor and monitor fitted from the
    job's synthetic data at its seed, the fixture's trees (the bundle's
    tree file, no estimator) and temperature."""
    from mlops_tpu_torch.bundle import save_sklearn_bundle
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.ops.gbm_tensor import load_gbm_tensor

    config = job_config(Path(directory))  # no registry is written
    preprocessor, train_ds, _ = _split(config)
    monitor = fit_monitor(
        train_ds,
        drift_ref_size=config.monitor.drift_ref_size,
        seed=config.data.seed,
        outlier_quantile=config.monitor.outlier_quantile,
    )
    temperature = float(read_fixture(fixture)["temperature"])
    return save_sklearn_bundle(
        directory, config.model, preprocessor, monitor,
        gbm_tensor=load_gbm_tensor(fixture), calibration={"temperature": temperature},
    )


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    path = write_fixture(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE)
    fixture = read_fixture(path)
    print(f"{path}: {fixture['n_trees']} trees of {fixture['max_nodes']} nodes, "
          f"depth {fixture['depth']}, T = {fixture['temperature']}, "
          f"sklearn {fixture['sklearn_version']}, {path.stat().st_size} bytes")
