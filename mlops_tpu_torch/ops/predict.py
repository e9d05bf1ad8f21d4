"""The exact tier's packed programs and the packed layout shared by the
engine and the tests.

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

from typing import Callable

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
