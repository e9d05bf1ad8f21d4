"""The packed output layout shared by the engine and the tests."""

from __future__ import annotations

from mlops_tpu_torch.schema.features import SCHEMA


def packed_layout(rows: int) -> tuple[slice, slice, slice]:
    """(predictions, outliers, drift) slices of a packed row vector of
    ``rows`` padded rows: ``preds ‖ flags ‖ drift``."""
    d = SCHEMA.num_categorical + SCHEMA.num_numeric
    return (
        slice(0, rows),
        slice(rows, 2 * rows),
        slice(2 * rows, 2 * rows + d),
    )
