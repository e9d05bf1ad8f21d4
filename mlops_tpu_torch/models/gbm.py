"""The sklearn tree-ensemble floor: a copy of the JAX package's
``models/gbm.py``.

The reference's production model is an sklearn ``RandomForestClassifier``
(SURVEY.md §0). Tree ensembles are not the card's path; they are the
comparison floor every neural family is measured against, and they serve
through the same bundle and engine interface (``flavor: "sklearn"`` in the
manifest):

- ``gbm``: ``HistGradientBoostingClassifier`` with native categorical
  support. A fitted one also serves on the card as a tensor program
  (``ops/gbm_tensor.py``), from the tree file the bundle carries beside
  its estimator;
- ``rf``: ``RandomForestClassifier``, the reference's own family, scored
  on the host (``ops/predict.py make_hybrid_predict_fn``).

Inputs are the zoo's ``(cat_ids int32 [N, C], numeric f32 [N, M])``:
HistGBM takes the ids as native categoricals, RF ordinally. sklearn and
joblib are imported inside the functions that need them, so a process
without them (the card's) imports this module and serves a gbm bundle's
tree file.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mlops_tpu_torch.config import ModelConfig, TrainConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.schema.features import SCHEMA

SKLEARN_FAMILIES = ("gbm", "rf")


class SklearnBaseline:
    """A fitted tree ensemble with the zoo's predict convention."""

    def __init__(self, estimator: Any, family: str):
        self.estimator = estimator
        self.family = family

    @classmethod
    def train(
        cls,
        model_config: ModelConfig,
        train_config: TrainConfig,
        train_ds: EncodedDataset,
    ) -> "SklearnBaseline":
        X = _design_matrix(train_ds)
        y = np.asarray(train_ds.labels)
        family = model_config.family
        if family == "gbm":
            from sklearn.ensemble import HistGradientBoostingClassifier

            est = HistGradientBoostingClassifier(
                max_iter=model_config.n_estimators,
                max_depth=model_config.max_tree_depth or None,
                categorical_features=list(range(SCHEMA.num_categorical)),
                random_state=train_config.seed,
            )
        elif family == "rf":
            from sklearn.ensemble import RandomForestClassifier

            est = RandomForestClassifier(
                n_estimators=model_config.n_estimators,
                max_depth=model_config.max_tree_depth or None,
                n_jobs=-1,
                random_state=train_config.seed,
            )
        else:
            raise ValueError(
                f"unknown sklearn family {family!r}; one of {SKLEARN_FAMILIES}"
            )
        est.fit(X, y)
        return cls(est, family)

    def predict_proba(self, cat_ids: np.ndarray, numeric: np.ndarray) -> np.ndarray:
        """P(default) per row, f32: the zoo's ``sigmoid(logits)``."""
        X = _design_matrix_arrays(cat_ids, numeric)
        return self.estimator.predict_proba(X)[:, 1].astype(np.float32)

    def evaluate(self, ds: EncodedDataset) -> dict[str, float]:
        """The reference-named validation metrics (``train/metrics.py``),
        from logits of the clipped probabilities."""
        from mlops_tpu_torch.train.metrics import binary_metrics

        probs = self.predict_proba(ds.cat_ids, ds.numeric)
        p = np.clip(probs, 1e-7, 1.0 - 1e-7)
        logits = torch.from_numpy(np.log(p / (1.0 - p)))
        metrics = binary_metrics(logits, torch.from_numpy(np.asarray(ds.labels)))
        return {f"validation_{k}_score": float(v) for k, v in metrics.items()}

    def to_bytes(self) -> bytes:
        """The JAX package's ``estimator.joblib`` payload: a dict of the
        family and the raw estimator, so either package loads it."""
        import joblib

        buf = io.BytesIO()
        joblib.dump({"family": self.family, "estimator": self.estimator}, buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "SklearnBaseline":
        import joblib

        payload = joblib.load(io.BytesIO(data))
        return cls(payload["estimator"], payload["family"])

    def save(self, path: str | Path) -> None:
        Path(path).write_bytes(self.to_bytes())

    @classmethod
    def load(cls, path: str | Path) -> "SklearnBaseline":
        return cls.from_bytes(Path(path).read_bytes())


def _design_matrix_arrays(cat_ids: np.ndarray, numeric: np.ndarray) -> np.ndarray:
    """``[cat_ids | numeric]`` as f64: one layout for fit and predict."""
    return np.concatenate(
        [np.asarray(cat_ids, np.float64), np.asarray(numeric, np.float64)],
        axis=1,
    )


def _design_matrix(ds: EncodedDataset) -> np.ndarray:
    return _design_matrix_arrays(ds.cat_ids, ds.numeric)
