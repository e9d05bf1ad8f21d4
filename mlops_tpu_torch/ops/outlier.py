"""Mahalanobis outlier scoring (port of the JAX package's ``ops/outlier.py``).

The reference detector is ``IForest(threshold=0.95)`` on the numeric
features; the served detector is the squared Mahalanobis distance with
its threshold at the same training quantile. ``fit_mahalanobis`` is the
host-side numpy fit, identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def mahalanobis_sq(
    x: torch.Tensor,  # f32 [..., M]
    mean: torch.Tensor,  # f32 [M]
    precision: torch.Tensor,  # f32 [M, M] inverse covariance
) -> torch.Tensor:
    """Squared Mahalanobis distance per row: ``((x-mu) P) . (x-mu)``."""
    centered = x - mean
    return ((centered @ precision) * centered).sum(dim=-1)


def fit_mahalanobis(
    x: np.ndarray, quantile: float = 0.95, ridge: float = 1e-6
) -> tuple[np.ndarray, np.ndarray, float]:
    """Host-side fit: mean, precision (ridge-regularized), threshold at the
    empirical ``quantile`` of the training distances."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0)
    cov = np.cov(x, rowvar=False)
    cov += ridge * np.eye(cov.shape[0])
    precision = np.linalg.inv(cov)
    centered = x - mean
    distances = np.einsum("ni,ij,nj->n", centered, precision, centered)
    threshold = float(np.quantile(distances, quantile))
    return (
        mean.astype(np.float32),
        precision.astype(np.float32),
        threshold,
    )
