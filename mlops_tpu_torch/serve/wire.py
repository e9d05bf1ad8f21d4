"""The serving wire contract: group geometry and response shape.

A copy of the JAX package's ``serve/wire.py``: the same group shape grid
and the same response formatting, so a response from the port is
byte-for-byte in the reference's format.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from mlops_tpu_torch.schema.features import SCHEMA

# Grouped-dispatch shape grid: concurrent small requests stack into
# [slots, rows, ...] — slots padded up to a slot bucket, each slot padded
# to a row bucket (1 for all-batch-1 groups, 8 otherwise).
GROUP_SLOT_BUCKETS = (2, 4, 8, 16, 32, 64)
GROUP_ROW_BUCKETS = (1, 8)
GROUP_ROW_BUCKET = GROUP_ROW_BUCKETS[-1]


def format_response(
    predictions: np.ndarray, outliers: np.ndarray, drift: np.ndarray
) -> dict[str, Any]:
    """Raw response arrays -> the reference response dict. Inputs are the
    engine's raw-fetch contract: f64 predictions/outliers of the request's
    row count and the f64 drift vector already rounded to 6 places."""
    return {
        "predictions": predictions.tolist(),
        "outliers": outliers.tolist(),
        "feature_drift_batch": dict(zip(SCHEMA.feature_names, drift.tolist())),
    }


def empty_response() -> dict[str, Any]:
    """The zero-row response (no device work, no drift signal)."""
    return {
        "predictions": [],
        "outliers": [],
        "feature_drift_batch": dict.fromkeys(SCHEMA.feature_names, 0.0),
    }


# The response's static skeleton (braces, key names, the drift feature
# keys) is baked once; `encode_response` serializes only the floats, in
# one C `json.dumps` call, and splices the skeleton around them.
_DRIFT_KEYS = tuple(
    json.dumps(name) + ":" for name in SCHEMA.feature_names
)


def encode_response(
    predictions: np.ndarray, outliers: np.ndarray, drift: np.ndarray
) -> bytes:
    """Raw response arrays -> wire bytes, byte-identical to
    ``json.dumps(format_response(...), separators=(",", ":")).encode()``."""
    # The "],[" delimiter never occurs inside a rendered float, so the
    # three segments split back out exactly, empty lists included.
    floats = json.dumps(
        [
            np.asarray(predictions).tolist(),
            np.asarray(outliers).tolist(),
            np.asarray(drift).tolist(),
        ],
        separators=(",", ":"),
    )
    preds, outs, drifts = floats[2:-2].split("],[")
    return (
        '{"predictions":['
        + preds
        + '],"outliers":['
        + outs
        + '],"feature_drift_batch":{'
        + ",".join(map(str.__add__, _DRIFT_KEYS, drifts.split(",")))
        + "}}"
    ).encode()


EMPTY_RESPONSE_BYTES = json.dumps(
    empty_response(), separators=(",", ":")
).encode()
