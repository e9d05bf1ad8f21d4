"""The gbm tier: a fitted HistGBM ensemble as a tensor program
(Hummingbird-style), in the packed serving contract of every other tier.

A port of the JAX package's ``ops/gbm_tensor.py``:

- ``extract_gbm`` (numpy, copied as is) flattens the fitted ensemble into
  padded per-tree node arrays (value, threshold, child pointers, leaf and
  categorical flags) and a per-node 256-entry categorical go-left table
  built from the estimator's raw category bitsets, shaped ``[T, N]``;
- ``save_gbm_tensor`` / ``load_gbm_tensor`` write and read those arrays,
  the geometry and the ``GBM_FORMAT`` tag as one npz with numpy alone:
  the tree file a bundle carries, so a process without scikit-learn (the
  card's) serves the tier;
- ``make_gbm_packed_base`` / ``make_gbm_grouped_base`` are the packed
  programs in the 7-argument form of ``ops/predict.py``: the tree tensors
  are the ``params`` argument, the monitors run beside them, one flat f32
  output and the accumulator folded in place.

Traversal is a depth-many loop of gathers: each step reads every tree's
current node fields at once (``[B, T]``), resolves the split (numeric
``x <= threshold``; categorical through the table, where an unknown
category takes the missing side; NaN takes the missing side) and moves
the node index; leaves loop onto themselves, so ragged trees need no
control flow.

Bit parity: sklearn compares f64 feature values with f64 thresholds, adds
f64 leaf values tree by tree onto the baseline, then takes the expit. The
program does exactly that, with explicit dtypes (no x64 context exists
here): f64 compares, the same serial add chain in tree order (a sum over
the tree axis could reassociate), ``1 / (1 + exp(-s))`` on the f64 score,
one narrowing cast, and the tempered branch in f64 on a f64 temperature.
The monitors stay f32, so the packed buffer is one f32 vector as on every
other tier.

No kernel is written by hand for this tier: the JAX program is ``jnp``
(a gather/compare loop), not Pallas, so PyTorch's ops are its
counterpart. On the card the engine captures each shape's program into a
CUDA graph.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from mlops_tpu_torch.monitor.state import (
    drift_scores,
    fold_accumulator,
    fold_accumulator_grouped,
    outlier_flags,
)
from mlops_tpu_torch.ops.cuda_build import LaunchCounter
from mlops_tpu_torch.train.calibrate import PROB_EPS

# The tensorized layout's format tag, the JAX package's (its compile-cache
# hash carries it); the tree file records it and ``load_gbm_tensor``
# refuses another.
GBM_FORMAT = "gbm-gather-v1"

# Replays of the gbm tier's CUDA graphs (``serve/graphs.py``): the count
# that shows a dispatch on the card ran a captured tree program.
gbm_graph_replays = LaunchCounter("gbm_graph")

# Raw category ids the table covers: HistGBM bins categories into
# [0, 255], so any raw value outside it is unknown -> the missing side.
_CAT_LUT_SIZE = 256

# The tree arrays of ``extract_gbm``'s dict, in order, with the dtype each
# has on the device (the indices widened to int64 for torch's gathers).
GBM_FIELDS = {
    "value": torch.float64,
    "threshold": torch.float64,
    "feature": torch.int64,
    "left": torch.int64,
    "right": torch.int64,
    "is_leaf": torch.bool,
    "is_cat": torch.bool,
    "mgtl": torch.bool,
    "cat_go_left": torch.bool,
    "baseline": torch.float64,
}


@dataclasses.dataclass(frozen=True)
class GbmGeometry:
    """Static shape facts of one tensorized ensemble: what the program's
    structure depends on beyond the tensors' shapes."""

    n_trees: int
    max_nodes: int
    depth: int  # traversal steps = the deepest decision path


def _unwrap(estimator: Any) -> Any:
    """The raw sklearn estimator, or the one ``SklearnBaseline`` wraps."""
    return getattr(estimator, "estimator", estimator)


def supports_gbm_tensorization(estimator: Any) -> bool:
    """True when ``estimator`` is (or wraps) a fitted binary
    HistGradientBoostingClassifier this module can lower (the rf family
    keeps the host hybrid: unbinned deep forests explode ``max_nodes``)."""
    estimator = _unwrap(estimator)
    predictors = getattr(estimator, "_predictors", None)
    if not predictors:
        return False
    classes = getattr(estimator, "classes_", None)
    if classes is None or len(classes) != 2:
        return False
    return hasattr(estimator, "_bin_mapper")


def _bit(bitset_row: np.ndarray, value: int) -> bool:
    return bool((int(bitset_row[value // 32]) >> (value % 32)) & 1)


def extract_gbm(estimator: Any) -> tuple[dict[str, np.ndarray], GbmGeometry]:
    """Fitted HistGBM -> (tree arrays, geometry); the JAX package's
    function. The dict holds ``value``/``threshold`` f64 ``[T, N]``,
    ``feature``/``left``/``right`` i32, ``is_leaf`` (padding nodes are
    leaves), ``is_cat``, ``mgtl`` (missing goes left) bool, the
    ``cat_go_left`` bool ``[T, N, 256]`` table (go left for raw category
    v: v's bit in the split's raw bitset when v is a known category of
    the feature, else the missing side) and the f64 ``baseline``."""
    estimator = _unwrap(estimator)
    predictors = [trees[0] for trees in estimator._predictors]
    baseline = float(np.asarray(estimator._baseline_prediction).ravel()[0])
    known_bitsets, f_idx_map = estimator._bin_mapper.make_known_categories_bitsets()

    n_trees = len(predictors)
    max_nodes = max(p.nodes.shape[0] for p in predictors)
    value = np.zeros((n_trees, max_nodes), np.float64)
    threshold = np.zeros((n_trees, max_nodes), np.float64)
    feature = np.zeros((n_trees, max_nodes), np.int32)
    left = np.zeros((n_trees, max_nodes), np.int32)
    right = np.zeros((n_trees, max_nodes), np.int32)
    is_leaf = np.ones((n_trees, max_nodes), bool)  # padding = leaf
    is_cat = np.zeros((n_trees, max_nodes), bool)
    mgtl = np.zeros((n_trees, max_nodes), bool)
    cat_go_left = np.zeros((n_trees, max_nodes, _CAT_LUT_SIZE), bool)

    depth = 1
    for t, pred in enumerate(predictors):
        nodes = pred.nodes
        n = nodes.shape[0]
        value[t, :n] = nodes["value"]
        threshold[t, :n] = nodes["num_threshold"]
        feature[t, :n] = nodes["feature_idx"]
        left[t, :n] = nodes["left"]
        right[t, :n] = nodes["right"]
        is_leaf[t, :n] = nodes["is_leaf"].astype(bool)
        mgtl[t, :n] = nodes["missing_go_to_left"].astype(bool)
        cat_mask = nodes["is_categorical"].astype(bool)
        is_cat[t, :n] = cat_mask
        for i in np.nonzero(cat_mask)[0]:
            raw_bits = pred.raw_left_cat_bitsets[int(nodes["bitset_idx"][i])]
            known_row = known_bitsets[int(f_idx_map[nodes["feature_idx"][i]])]
            miss = bool(nodes["missing_go_to_left"][i])
            for v in range(_CAT_LUT_SIZE):
                cat_go_left[t, i, v] = _bit(raw_bits, v) if _bit(known_row, v) else miss
        # The tree's decision depth: its longest root -> leaf path.
        node_depth = np.zeros(n, np.int32)
        for i in range(n):  # parents precede children in the node array
            if not is_leaf[t, i]:
                for child in (int(left[t, i]), int(right[t, i])):
                    node_depth[child] = max(node_depth[child], node_depth[i] + 1)
        depth = max(depth, int(node_depth.max()))

    variables = {
        "value": value,
        "threshold": threshold,
        "feature": feature,
        "left": left,
        "right": right,
        "is_leaf": is_leaf,
        "is_cat": is_cat,
        "mgtl": mgtl,
        "cat_go_left": cat_go_left,
        "baseline": np.float64(baseline),
    }
    return variables, GbmGeometry(n_trees=n_trees, max_nodes=max_nodes, depth=depth)


def save_gbm_tensor(path: str | Path, variables: dict[str, np.ndarray],
                    geometry: GbmGeometry) -> Path:
    """Write ``extract_gbm``'s arrays, the geometry and ``GBM_FORMAT`` to
    one compressed npz (numpy alone reads it back)."""
    path = Path(path)
    np.savez_compressed(
        path,
        **{k: np.asarray(variables[k]) for k in GBM_FIELDS},
        format=np.array(GBM_FORMAT),
        **{k: np.int64(v) for k, v in dataclasses.asdict(geometry).items()},
    )
    return path


def load_gbm_tensor(path: str | Path) -> tuple[dict[str, np.ndarray], GbmGeometry]:
    """The tree file's ``(arrays, geometry)``; refuses another format."""
    with np.load(path) as data:
        stored = str(data["format"])
        if stored != GBM_FORMAT:
            raise ValueError(
                f"{path} holds gbm trees in format {stored!r}; this package "
                f"serves {GBM_FORMAT!r} — re-package the bundle"
            )
        variables = {k: data[k] for k in GBM_FIELDS}
        geometry = GbmGeometry(**{
            f.name: int(data[f.name]) for f in dataclasses.fields(GbmGeometry)
        })
    variables["baseline"] = np.float64(variables["baseline"])
    return variables, geometry


def gbm_tensor_bytes(variables: dict[str, torch.Tensor]) -> int:
    """Bytes the tree tensors hold on their device."""
    return sum(t.numel() * t.element_size() for t in variables.values())


def gbm_raw_scores(variables: dict[str, torch.Tensor], depth: int,
                   cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
    """The ensemble's raw f64 decision scores for ``[B]`` rows: the
    gather/compare traversal of the module docstring. ``variables`` are
    the device tensors of ``weights.gbm_variables_from_numpy``."""
    # The design matrix [cat_ids | numeric] in f64, as sklearn's: int32
    # ids and f32 numerics widen exactly.
    xall = torch.cat([cat_ids.to(torch.float64), numeric.to(torch.float64)], dim=1)
    n_trees, max_nodes = variables["value"].shape
    # Node fields are read through flat indices tree * N + node: one
    # gather per field per step.
    base = torch.arange(n_trees, device=xall.device) * max_nodes
    flat = {k: variables[k].reshape(-1) for k in
            ("value", "threshold", "feature", "left", "right", "is_leaf", "is_cat",
             "mgtl", "cat_go_left")}
    idx = torch.zeros((xall.shape[0], n_trees), dtype=torch.int64, device=xall.device)
    for _ in range(depth):
        node = base + idx  # [B, T]
        leaf = flat["is_leaf"][node]
        thr = flat["threshold"][node]
        miss = flat["mgtl"][node]
        cat = flat["is_cat"][node]
        xv = torch.gather(xall, 1, flat["feature"][node])
        # Categorical resolution: an integral raw value inside the table's
        # range reads the node's table (which holds the unknown-category
        # rule); any other value is unknown. NaN reads entry 0 here and
        # takes the missing side below.
        vi = torch.nan_to_num(xv, nan=0.0).clamp(0, _CAT_LUT_SIZE - 1).to(torch.int64)
        in_range = (xv >= 0) & (xv < _CAT_LUT_SIZE) & (xv == torch.floor(xv))
        cat_go = flat["cat_go_left"][node * _CAT_LUT_SIZE + vi]
        go_left = torch.where(
            torch.isnan(xv),
            miss,
            torch.where(cat, torch.where(in_range, cat_go, miss), xv <= thr),
        )
        nxt = torch.where(go_left, flat["left"][node], flat["right"][node])
        idx = torch.where(leaf, idx, nxt)
    leaf_values = flat["value"][base + idx]  # [B, T] f64
    # Serial accumulation in tree order, as sklearn adds one iteration's
    # predictions at a time onto the baseline.
    score = variables["baseline"] + leaf_values[:, 0]
    for t in range(1, n_trees):
        score = score + leaf_values[:, t]
    return score


def _gbm_predictions(variables, depth: int, temperature: torch.Tensor,
                     cat_ids: torch.Tensor, numeric: torch.Tensor) -> torch.Tensor:
    """Raw traversal -> the host hybrid's exact f32 probabilities:
    ``apply_temperature(predict_proba(X), T)``, that is the expit of the
    f64 score narrowed once to f32, then only when T != 1 the clipped
    logit rescale in f64 narrowed again. ``temperature`` is a f64 tensor
    (the host divides by the full Python float; an f32 T moves about a
    third of the tempered probabilities by one ulp), so the T == 1
    shortcut is a select."""
    raw = gbm_raw_scores(variables, depth, cat_ids, numeric)
    p32 = (1.0 / (1.0 + torch.exp(-raw))).to(torch.float32)
    t64 = temperature.to(torch.float64)
    p64 = torch.clamp(p32.to(torch.float64), PROB_EPS, 1.0 - PROB_EPS)
    logits = torch.log(p64) - torch.log1p(-p64)
    tempered = (1.0 / (1.0 + torch.exp(-logits / t64))).to(torch.float32)
    return torch.where(temperature == 1.0, p32, tempered)


def make_gbm_packed_base(depth: int) -> Callable:
    """The gbm tier's solo packed program: ``(variables, monitor, acc,
    temperature f64, cat_ids [B, C], numeric [B, M], mask [B]) ->
    (packed f32[2B + D], new_acc)``. ``depth`` is static structure
    (``GbmGeometry``)."""

    def predict(variables, monitor, acc, temperature, cat_ids, numeric, mask):
        preds = _gbm_predictions(variables, depth, temperature, cat_ids, numeric)
        flags = outlier_flags(monitor, numeric, mask)
        drift = drift_scores(monitor, cat_ids, numeric, mask)
        packed = torch.cat([preds, flags, drift])
        return packed, fold_accumulator(acc, flags, drift, mask)

    return predict


def make_gbm_grouped_base(depth: int) -> Callable:
    """The grouped form: inputs ``[S, R, ...]`` -> ``(packed f32[S, 2R +
    D], new_acc)``. As on the exact tier, the trees score the S*R rows in
    one call (rows are independent, and each row's add chain is its own);
    flags and drift are per slot over the slot's own rows."""

    def grouped(variables, monitor, acc, temperature, cat_ids, numeric, mask):
        s, r = mask.shape
        preds = _gbm_predictions(
            variables, depth, temperature,
            cat_ids.reshape(s * r, -1), numeric.reshape(s * r, -1),
        ).reshape(s, r)
        flags = outlier_flags(monitor, numeric, mask)
        drift = drift_scores(monitor, cat_ids, numeric, mask)
        packed = torch.cat([preds, flags, drift], dim=1)
        return packed, fold_accumulator_grouped(acc, flags, drift, mask)

    return grouped


def gbm_reference_proba(variables: dict[str, torch.Tensor], geometry: GbmGeometry,
                        cat_ids, numeric) -> np.ndarray:
    """The traversal run once on the tensors' device, as untempered f32
    probabilities: the bridge the tests hold against both
    ``SklearnBaseline.predict_proba`` and the packed programs."""
    device = variables["value"].device
    with torch.inference_mode():
        raw = gbm_raw_scores(
            variables,
            geometry.depth,
            torch.as_tensor(np.asarray(cat_ids, np.int32), device=device),
            torch.as_tensor(np.asarray(numeric, np.float32), device=device),
        )
        return (1.0 / (1.0 + torch.exp(-raw))).to(torch.float32).cpu().numpy()
