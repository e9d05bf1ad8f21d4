"""Temperature scaling: a numpy copy of the JAX package's
``train/calibrate.py`` (the fit, and the probability-space rescale the
sklearn flavor serves with). Every bundle carries a temperature fitted on
the held-out split; serving divides the logit by it before the sigmoid,
which leaves rankings unchanged and makes the probabilities honest
(minimum validation NLL). With ``s = 1/T`` the NLL is convex in ``s``,
so a golden-section search on ``log s`` finds the optimum."""

from __future__ import annotations

import math

import numpy as np

_PHI = (math.sqrt(5.0) - 1.0) / 2.0  # golden ratio step

# The one clip epsilon shared by calibration fitting and every serving
# path that rebuilds logits from probabilities (the sklearn flavor), so
# fit-time and serve-time transforms are exact inverses.
PROB_EPS = 1e-7


def probs_to_logits(probs: np.ndarray) -> np.ndarray:
    """Inverse sigmoid with the shared clip (tree ensembles emit exact 0/1)."""
    p = np.clip(np.asarray(probs, np.float64), PROB_EPS, 1.0 - PROB_EPS)
    return np.log(p) - np.log1p(-p)


def apply_temperature(probs: np.ndarray, temperature: float) -> np.ndarray:
    """Re-scale probabilities through logit space: sigmoid(logit(p) / T)."""
    if temperature == 1.0:
        return np.asarray(probs)
    return 1.0 / (1.0 + np.exp(-probs_to_logits(probs) / temperature))


def binary_nll(logits: np.ndarray, labels: np.ndarray) -> float:
    """Mean negative log-likelihood of sigmoid(logits) against 0/1 labels."""
    z = np.asarray(logits, np.float64)
    y = np.asarray(labels, np.float64)
    return float(np.mean(np.logaddexp(0.0, z) - y * z))


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    log_s_range: tuple[float, float] = (-4.0, 4.0),
    iters: int = 80,
) -> float:
    """T minimizing the validation NLL of ``sigmoid(logits / T)``; 1.0 on
    a degenerate split (no logits, or one class)."""
    z = np.asarray(logits, np.float64)
    y = np.asarray(labels, np.float64)
    if z.size == 0 or np.unique(y).size < 2:
        return 1.0

    def nll_of(log_s: float) -> float:
        return binary_nll(z * math.exp(log_s), y)

    a, b = log_s_range
    c = b - _PHI * (b - a)
    d = a + _PHI * (b - a)
    fc, fd = nll_of(c), nll_of(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _PHI * (b - a)
            fc = nll_of(c)
        else:
            a, c, fc = c, d, fd
            d = a + _PHI * (b - a)
            fd = nll_of(d)
    return float(math.exp(-(a + b) / 2.0))  # T = 1/s


def calibration_record(logits: np.ndarray, labels: np.ndarray) -> dict[str, float]:
    """Fit T and report the validation NLL before and after, for the
    bundle manifest."""
    temperature = fit_temperature(logits, labels)
    z = np.asarray(logits, np.float64)
    return {
        "temperature": round(temperature, 6),
        "val_nll_uncalibrated": round(binary_nll(z, labels), 6),
        "val_nll_calibrated": round(binary_nll(z / temperature, labels), 6),
    }
