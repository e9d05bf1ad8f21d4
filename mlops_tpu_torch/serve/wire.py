"""The serving wire contract: group geometry, response shape and the
error answers every route shares.

A copy of the JAX package's ``serve/wire.py`` (group grid, response
formatting, ``DeadlineExceeded``) and of the two wire helpers of its
``serve/httpcore.py`` (``deadline_response``, ``profile_payload``), so a
response from the port is byte-for-byte in the reference's format.
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

# A ring slot's response status (serve/ipc.py): scored, failed, or
# completed unscored because its deadline budget ran out in the queue.
RESP_OK, RESP_ERROR, RESP_EXPIRED = 0, 1, 2


class DeadlineExceeded(Exception):
    """A request's deadline budget (``x-request-deadline-ms``) ran out
    before its work dispatched: the micro-batcher's claim-time purge
    completes the entry with this instead of dispatching it, and the
    handler answers the documented 504."""


def deadline_response(detail: str = "request deadline exceeded") -> tuple:
    """The deadline-exceeded answer: a ``504`` (distinct from a shed
    503: a 504'd request may or may not have been scored)."""
    return 504, {"detail": detail}, "application/json"


def profile_payload(
    status: int, action: str, profile_dir: str, err: str | None = None
) -> tuple:
    """The ``/debug/profile/{start,stop}`` answers for a profiler status
    (200 tracing/stopped, 409 already running/not running, 404 profiling
    disabled, else 500 with the error)."""
    if status == 200:
        state = "tracing" if action == "start" else "stopped"
        return 200, {"status": state, "dir": profile_dir}, "application/json"
    if status == 409:
        detail = (
            "trace already running" if action == "start"
            else "no trace running"
        )
        return 409, {"detail": detail}, "application/json"
    if status == 404:
        return 404, {"detail": "profiling disabled"}, "application/json"
    detail = f"profiler {action} failed"
    if err:
        detail = f"{detail}: {err}"
    return 500, {"detail": detail}, "application/json"


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
