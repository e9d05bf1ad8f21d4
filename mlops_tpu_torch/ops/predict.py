"""The exact tier's packed programs, the sklearn flavor's host hybrid
(``make_hybrid_predict_fn``) and the packed layout shared by the engine
and the tests.

Port of the JAX package's ``make_packed_predict_base`` and
``make_packed_grouped_base`` (``mlops_tpu/ops/predict.py:110,154``): one
call runs the classifier, ``sigmoid(logit / T)``, the Mahalanobis flags
and the chi-squared / K-S drift, lays them out as one f32 buffer
(``packed_layout``) and folds the running monitor accumulator. The
exact tier runs no hand-written kernel: its products, LayerNorms and
GELUs are plain PyTorch, as the JAX package leaves them to XLA.

As there, everything beyond the architecture is an argument: the
programs take the model's parameters (``model_params``: the module's
parameters with the casts to the compute type made once) and apply them
with ``torch.func.functional_call``, the counterpart of flax's
``apply``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from mlops_tpu_torch.models.layers import Dense, Embed
from mlops_tpu_torch.monitor.state import (
    MonitorAccumulator,
    MonitorState,
    drift_scores,
    fold_accumulator,
    fold_accumulator_grouped,
    outlier_flags,
)
from mlops_tpu_torch.schema.features import SCHEMA


def make_packed_predict_base(model: torch.nn.Module) -> Callable:
    """Solo packed program: ``(params, monitor, acc, temperature, cat_ids
    [B,C], numeric [B,M], mask [B]) -> (packed f32[2B+D], new_acc)``."""

    def predict(
        params: dict[str, torch.Tensor],
        monitor: MonitorState,
        acc: MonitorAccumulator,
        temperature: torch.Tensor,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        mask: torch.Tensor,
    ):
        logits = functional_call(model, params, (cat_ids, numeric))
        flags = outlier_flags(monitor, numeric, mask)
        drift = drift_scores(monitor, cat_ids, numeric, mask)
        packed = torch.cat([torch.sigmoid(logits / temperature), flags, drift])
        return packed, fold_accumulator(acc, flags, drift, mask)

    return predict


def make_packed_grouped_base(model: torch.nn.Module) -> Callable:
    """Grouped packed program: inputs ``[S, R, ...]`` -> ``(packed
    f32[S, 2R+D], new_acc)``. The model scores the S*R rows in one call
    (rows are independent); flags and drift are computed per slot over
    the slot's own rows, and the accumulator folds the non-empty slots."""

    def grouped(
        params: dict[str, torch.Tensor],
        monitor: MonitorState,
        acc: MonitorAccumulator,
        temperature: torch.Tensor,
        cat_ids: torch.Tensor,
        numeric: torch.Tensor,
        mask: torch.Tensor,
    ):
        s, r = mask.shape
        logits = functional_call(
            model, params, (cat_ids.reshape(s * r, -1), numeric.reshape(s * r, -1))
        ).reshape(s, r)
        flags = outlier_flags(monitor, numeric, mask)
        drift = drift_scores(monitor, cat_ids, numeric, mask)
        preds = torch.sigmoid(logits / temperature)
        packed = torch.cat([preds, flags, drift], dim=1)
        return packed, fold_accumulator_grouped(acc, flags, drift, mask)

    return grouped


def make_hybrid_predict_fn(
    estimator, monitor: MonitorState, temperature: float = 1.0
) -> Callable[[np.ndarray, np.ndarray, np.ndarray], dict[str, Any]]:
    """The sklearn flavor's predict where the ensemble does not tensorize
    (the rf floor; the JAX ``make_hybrid_predict_fn``): the trees score
    on the host while the drift and outlier monitors run on the monitor's
    device, with the response contract and the padding-mask semantics of
    the packed programs. Takes padded host arrays; returns a dict of
    ``predictions`` (host f32, padding 0), ``outliers`` and
    ``feature_drift_batch`` (device tensors). No accumulator: the server
    folds this flavor's monitor totals on the host."""
    from mlops_tpu_torch.train.calibrate import apply_temperature

    device = monitor.cat_ref_counts.device

    def predict(cat_ids: np.ndarray, numeric: np.ndarray, mask: np.ndarray):
        cat_t, num_t, mask_t = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (cat_ids, numeric, mask)
        )
        with torch.inference_mode():
            out = {
                "outliers": outlier_flags(monitor, num_t, mask_t),
                "feature_drift_batch": drift_scores(monitor, cat_t, num_t, mask_t),
            }
        # Only the valid rows reach the trees; the output keeps the
        # bucket's length.
        valid = np.asarray(mask, bool)
        probs = np.zeros(valid.shape[0], np.float32)
        p = estimator.predict_proba(np.asarray(cat_ids)[valid], np.asarray(numeric)[valid])
        probs[valid] = apply_temperature(p, temperature)
        out["predictions"] = probs
        return out

    return predict


def packed_layout(rows: int) -> tuple[slice, slice, slice]:
    """(predictions, outliers, drift) slices of a packed row vector of
    ``rows`` padded rows: ``preds ‖ flags ‖ drift``."""
    d = SCHEMA.num_categorical + SCHEMA.num_numeric
    return (
        slice(0, rows),
        slice(rows, 2 * rows),
        slice(2 * rows, 2 * rows + d),
    )


def model_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The parameters a packed program takes for ``model``: each Dense
    kernel and bias and each Embed table already in the model's compute
    type, the cast every forward would otherwise make again (casting once
    gives the same bits), LayerNorm's f32 scale and bias as they are."""
    params = {}
    for prefix, module in model.named_modules():
        cast = isinstance(module, (Dense, Embed))
        for name, p in module.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            params[key] = p.detach().to(module.dtype) if cast else p.detach()
    return params
