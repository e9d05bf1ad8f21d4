"""Helpers of the lifecycle tests (``test_torch_lifecycle_*.py``): the
JAX suite's lifecycle scenery (``tests/test_lifecycle.py``) for both
packages — the tiny JAX-trained incumbent of ``tiny_pipeline`` (mlp,
hidden (32, 32), embed 4), a labeled DRIFTED window on disk (1,500
synthetic rows, numerics x10), normal and drifted traffic encoded with
the incumbent's preprocessor, the suite's loop knobs in each package's
config, and a per-test SIGALRM budget.
"""

from __future__ import annotations

import signal
from pathlib import Path

import pytest

TEST_BUDGET_S = 120


@pytest.fixture(autouse=True)
def budget():
    """Each test's own time limit: SIGALRM fails a test that outlives
    TEST_BUDGET_S instead of letting it hang the run."""
    def expire(*_):
        raise TimeoutError(f"the test outlived its {TEST_BUDGET_S} s budget")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_BUDGET_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def lifecycle_knobs(config, td: Path, labeled) -> None:
    """The JAX suite's ``_lifecycle_config`` knobs, on either package's
    ``Config``."""
    lc = config.lifecycle
    lc.enabled = True
    lc.dir = str(td / "lifecycle")
    lc.labeled_path = str(labeled)
    lc.retrain_steps = 50
    lc.min_labeled_rows = 500
    lc.min_window_rows = 32
    lc.hysteresis_windows = 2
    lc.cooldown_s = 0.0
    lc.mirror_fraction = 1.0
    lc.shadow_min_mirrors = 4
    lc.max_ece = 0.3  # tiny fixtures calibrate coarsely


def port_config(td: Path, labeled):
    from mlops_tpu_torch.config import Config

    config = Config()
    config.train.device = "cpu"
    config.serve.device = "cpu"
    lifecycle_knobs(config, td, labeled)
    return config


def jax_config(td: Path, labeled):
    from mlops_tpu.config import Config

    config = Config()
    lifecycle_knobs(config, td, labeled)
    return config


def write_drifted_window(path: Path, rows: int = 1500, seed: int = 3) -> Path:
    """A labeled drifted window: synthetic rows, numerics x10, labels as
    drawn (``scripts/lifecycle_smoke.py``'s window)."""
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.data.ingest import write_csv_columns
    from mlops_tpu_torch.schema.features import SCHEMA

    columns, labels = generate_synthetic(rows, seed=seed)
    for feat in SCHEMA.numeric:
        columns[feat.name] = [v * 10.0 for v in columns[feat.name]]
    write_csv_columns(path, columns, labels)
    return path


def traffic(preprocessor, rows: int = 64, seed: int = 9):
    """(normal, drifted) encoded request rows: synthetic rows and the same
    rows with numerics x10."""
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.schema.features import SCHEMA

    norm_cols, _ = generate_synthetic(rows, seed=seed)
    drift_cols = {k: list(v) for k, v in norm_cols.items()}
    for feat in SCHEMA.numeric:
        drift_cols[feat.name] = [v * 10.0 for v in drift_cols[feat.name]]
    return preprocessor.encode(norm_cols), preprocessor.encode(drift_cols)


def feed(engine, ds, batch: int = 8) -> int:
    """Serve ``ds`` in ``batch``-row requests; returns the rows served."""
    for lo in range(0, ds.cat_ids.shape[0], batch):
        engine.predict_arrays(ds.cat_ids[lo:lo + batch], ds.numeric[lo:lo + batch])
    return int(ds.cat_ids.shape[0])


@pytest.fixture(scope="module")
def scenery(tiny_pipeline, tmp_path_factory):
    """The incumbent (JAX-written, loaded by the port), its directory, the
    labeled window, and the port's encoded normal and drifted traffic."""
    from mlops_tpu_torch.bundle import load_bundle

    td = tmp_path_factory.mktemp("lifecycle")
    _, result = tiny_pipeline
    bundle = load_bundle(result.bundle_dir)
    labeled = write_drifted_window(td / "labeled.csv")
    normal, drifted = traffic(bundle.preprocessor)
    return {
        "td": td,
        "bundle_dir": Path(result.bundle_dir),
        "bundle": bundle,
        "labeled": labeled,
        "normal": normal,
        "drifted": drifted,
    }
