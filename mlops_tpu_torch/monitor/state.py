"""Fitted monitor state and the device-resident accumulator.

Port of the JAX package's ``monitor/state.py``: the same six arrays, read
from and written to the same ``monitor.npz``, held here as a dataclass of
tensors instead of a flax pytree; the same accumulator and the same two
folds, written as plain functions on tensors.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.ops.outlier import fit_mahalanobis
from mlops_tpu_torch.schema.features import SCHEMA

# Fit-time defaults of the JAX package's MonitorConfig (config.py):
# reference sample size for the K-S test and the outlier quantile.
DRIFT_REF_SIZE = 2048
OUTLIER_QUANTILE = 0.95

_FIELDS = (
    "cat_ref_counts",
    "num_ref_sorted",
    "num_ref_cdf",
    "out_mean",
    "out_precision",
    "out_threshold",
)


@dataclasses.dataclass(frozen=True)
class MonitorState:
    """Everything the fused predict needs, as fixed-shape f32 tensors.

    - ``cat_ref_counts``  [C, max_card]: training category counts.
    - ``num_ref_sorted``  [M, R]: sorted training reference sample per
      numeric feature.
    - ``num_ref_cdf``     [M, R]: each reference's right-continuous ECDF
      at its own points (ties collapse to the last occurrence).
    - ``out_mean`` [M], ``out_precision`` [M, M], ``out_threshold`` []:
      the Mahalanobis detector.
    """

    cat_ref_counts: torch.Tensor
    num_ref_sorted: torch.Tensor
    num_ref_cdf: torch.Tensor
    out_mean: torch.Tensor
    out_precision: torch.Tensor
    out_threshold: torch.Tensor

    def to(self, device: torch.device | str) -> "MonitorState":
        return MonitorState(
            **{k: getattr(self, k).to(device) for k in _FIELDS}
        )

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {k: getattr(self, k).cpu().numpy() for k in _FIELDS}

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "MonitorState":
        arrays = dict(arrays)
        if "num_ref_cdf" not in arrays:  # bundles saved before the field
            arrays["num_ref_cdf"] = _ref_cdf(
                np.asarray(arrays["num_ref_sorted"])
            )
        return cls(
            **{
                k: torch.from_numpy(
                    np.array(arrays[k], dtype=np.float32, copy=True)
                )
                for k in _FIELDS
            }
        )

    def save(self, path: str | Path) -> None:
        np.savez(Path(path).with_suffix(".npz"), **self.to_arrays())

    @classmethod
    def load(cls, path: str | Path) -> "MonitorState":
        with np.load(Path(path).with_suffix(".npz")) as data:
            return cls.from_arrays({k: data[k] for k in data.files})


def _ref_cdf(ref_sorted: np.ndarray) -> np.ndarray:
    """Right-continuous ECDF of each sorted reference row at its own
    points (``searchsorted(..., side="right") / R``)."""
    m, r = ref_sorted.shape
    out = np.empty((m, r), dtype=np.float32)
    for j in range(m):
        out[j] = np.searchsorted(
            ref_sorted[j], ref_sorted[j], side="right"
        ) / float(r)
    return out


def fit_monitor(
    ds: EncodedDataset,
    drift_ref_size: int = DRIFT_REF_SIZE,
    seed: int = 0,
    outlier_quantile: float = OUTLIER_QUANTILE,
) -> MonitorState:
    """Host-side numpy fit on the encoded training split; the same
    arithmetic and the same ``default_rng(seed)`` subsample as the JAX
    package's ``fit_monitor``."""
    max_card = max(SCHEMA.cards)
    counts = np.zeros((SCHEMA.num_categorical, max_card), dtype=np.float32)
    for j, feat in enumerate(SCHEMA.categorical):
        binc = np.bincount(ds.cat_ids[:, j], minlength=feat.card)
        counts[j, : feat.card] = binc

    rng = np.random.default_rng(seed)
    n = ds.numeric.shape[0]
    size = min(drift_ref_size, n)
    idx = rng.choice(n, size=size, replace=False)
    ref = np.sort(ds.numeric[idx].astype(np.float32), axis=0).T  # [M, R]

    mean, precision, threshold = fit_mahalanobis(
        ds.numeric, quantile=outlier_quantile
    )
    return MonitorState.from_arrays(
        {
            "cat_ref_counts": counts,
            "num_ref_sorted": np.ascontiguousarray(ref),
            "num_ref_cdf": _ref_cdf(ref),
            "out_mean": mean,
            "out_precision": precision,
            "out_threshold": np.asarray(threshold, dtype=np.float32),
        }
    )


@dataclasses.dataclass(frozen=True)
class MonitorAccumulator:
    """Device-resident running aggregate of the serving monitors, all f32:
    ``rows`` (valid rows scored), ``outliers`` (flags raised), ``batches``
    (non-empty dispatches; grouped dispatches count one per non-empty
    slot), ``drift_sum`` [D] and ``drift_last`` [D]. The engine reads and
    resets it off the request path (``monitor_snapshot``), so the f32
    counters stay far below 2^24."""

    rows: torch.Tensor
    outliers: torch.Tensor
    batches: torch.Tensor
    drift_sum: torch.Tensor
    drift_last: torch.Tensor


def init_accumulator(device: torch.device | str) -> MonitorAccumulator:
    d =SCHEMA.num_categorical + SCHEMA.num_numeric

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return MonitorAccumulator(
        rows=zeros(), outliers=zeros(), batches=zeros(),
        drift_sum=zeros(d), drift_last=zeros(d),
    )


def fold_accumulator(
    acc: MonitorAccumulator,
    flags: torch.Tensor,  # f32 [B], already mask-zeroed
    drift: torch.Tensor,  # f32 [D]
    mask: torch.Tensor,  # bool [B]
) -> MonitorAccumulator:
    """Fold one padded batch. An all-padding batch contributes nothing,
    not even to ``drift_last``."""
    n_valid = mask.float().sum()
    nonempty = n_valid > 0
    # Select, don't multiply: drift over ZERO valid rows can be NaN (the
    # chi-squared path divides by the row count) and NaN * 0 is still
    # NaN — a multiplicative mask would poison the running sum forever.
    safe_drift = torch.where(nonempty, drift, torch.zeros_like(drift))
    return MonitorAccumulator(
        rows=acc.rows + n_valid,
        outliers=acc.outliers + flags.sum(),
        batches=acc.batches + nonempty.float(),
        drift_sum=acc.drift_sum + safe_drift,
        drift_last=torch.where(nonempty, drift, acc.drift_last),
    )


def fold_accumulator_grouped(
    acc: MonitorAccumulator,
    flags: torch.Tensor,  # f32 [S, R]
    drift: torch.Tensor,  # f32 [S, D]
    mask: torch.Tensor,  # bool [S, R]
) -> MonitorAccumulator:
    """Grouped-dispatch fold: padding SLOTS (mask all-false) are excluded
    everywhere; each non-empty slot counts as one batch and
    ``drift_last`` takes the mean drift over the non-empty slots."""
    slot_rows = mask.float().sum(dim=1)  # [S]
    slot_valid = slot_rows > 0
    n_slots = slot_valid.float().sum()
    # Select, don't multiply: PADDING slots compute drift over zero rows,
    # where the chi-squared path yields NaN — and NaN * 0 is still NaN.
    safe_drift = torch.where(
        slot_valid[:, None], drift, torch.zeros_like(drift)
    )
    drift_total = safe_drift.sum(dim=0)
    mean_drift = drift_total / torch.clamp(n_slots, min=1.0)
    return MonitorAccumulator(
        rows=acc.rows + slot_rows.sum(),
        outliers=acc.outliers + flags.sum(),
        batches=acc.batches + n_slots,
        drift_sum=acc.drift_sum + drift_total,
        drift_last=torch.where(n_slots > 0, mean_drift, acc.drift_last),
    )
