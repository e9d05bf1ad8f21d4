"""Shared by the port's bulk, stream and distill tests: the JAX package's
``tests/test_distill.py`` fixture (a 4-member mlp ensemble, hidden
(32, 32), embed 4, 4,000 synthetic rows, 150 steps at batch 256) trained
by the JAX ``run_training`` with ``train.distill_quant=true``, so its
bundle carries the exact ensemble, the distilled bulk student and the
gated quant tier. Inputs are made by numpy from a seed."""

import numpy as np

from mlops_tpu.config import Config, ModelConfig, TrainConfig
from mlops_tpu.train.pipeline import run_training

PRED_TOL = {"f32": 1e-5, "bf16": 1.6e-2}  # tests/test_torch_exact.py
DRIFT_ATOL = 1e-5
FLAG_BAND = 1e-5


def jax_config(root) -> Config:
    config = Config()
    config.data.rows = 4000
    config.model = ModelConfig(
        family="mlp", hidden_dims=(32, 32), embed_dim=4, ensemble_size=4
    )
    config.train = TrainConfig(
        steps=150, eval_every=150, batch_size=256, distill_quant=True
    )
    config.registry.root = str(root / "registry")
    config.registry.run_root = str(root / "runs")
    return config


def train_jax_bundle(root):
    """The JAX-written bundle directory (exact, bulk and quant tiers)."""
    return run_training(jax_config(root), register=False).bundle_dir


def rows(n: int, seed: int, cards) -> tuple[np.ndarray, np.ndarray]:
    """``n`` rows of category ids and standardised numerics from ``seed``."""
    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, n) for c in cards], axis=-1).astype(np.int32)
    num = rng.normal(size=(n, 14)).astype(np.float32)
    return cat, num


def assert_flags_match(got, want, num, monitor_arrays):
    """Outlier flags equal, except rows whose squared Mahalanobis distance
    lies within ``FLAG_BAND`` x the threshold of it."""
    mean = np.asarray(monitor_arrays["out_mean"], np.float64)
    prec = np.asarray(monitor_arrays["out_precision"], np.float64)
    thr = float(monitor_arrays["out_threshold"])
    centered = np.asarray(num, np.float64) - mean
    dist = np.einsum("ni,ij,nj->n", centered, prec, centered)
    off_band = np.abs(dist - thr) > FLAG_BAND * thr
    np.testing.assert_array_equal(np.asarray(got)[off_band], np.asarray(want)[off_band])
