"""Preprocessing: vocab/stat fit + fixed-shape array encoding.

A copy of the JAX package's ``data/encode.py`` (numpy only), reading and
writing the same ``preprocess.npz``. It replaces the reference's sklearn
ColumnTransformer
(`01-train-model.ipynb:195-227`: categorical SimpleImputer(constant) +
OneHotEncoder(handle_unknown="ignore"); numeric SimpleImputer(median)):

- categoricals -> int32 ids (an embedding lookup; unseen values -> OOV id,
  same semantics as handle_unknown).
- numerics -> median-imputed then standardized float32. Standardization is
  affine, so downstream K-S drift statistics are unchanged vs raw space.

The fitted state is a plain dict of numpy arrays, serialized into the model
bundle (the reference pickles the whole sklearn Pipeline instead;
`02-register-model.ipynb` cell 7).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from mlops_tpu_torch.schema.features import SCHEMA, FeatureSchema

# Vocab -> id lookup tables are schema constants (frozen dataclasses);
# building them inside encode() would put 9 array constructions on the
# serving hot path for every request batch. Stored sorted so the encode
# is a vectorized searchsorted instead of a per-value Python dict probe on
# the serving path.
_VOCAB_TABLES: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}


def _vocab_table(feat) -> tuple[np.ndarray, np.ndarray]:
    """``(sorted_vocab, ids_of_sorted)`` for one categorical feature."""
    key = (feat.name, feat.vocab)
    table = _VOCAB_TABLES.get(key)
    if table is None:
        vocab = np.asarray(feat.vocab)
        order = np.argsort(vocab)
        table = (vocab[order], order.astype(np.int32))
        _VOCAB_TABLES[key] = table
    return table


@dataclasses.dataclass
class EncodedDataset:
    """Fixed-shape encoded dataset ready for device placement."""

    cat_ids: np.ndarray  # int32 [N, num_categorical]
    numeric: np.ndarray  # float32 [N, num_numeric], standardized
    labels: np.ndarray | None = None  # int8/float32 [N]

    @property
    def n(self) -> int:
        return self.cat_ids.shape[0]

    def slice(self, idx: np.ndarray) -> "EncodedDataset":
        return EncodedDataset(
            cat_ids=self.cat_ids[idx],
            numeric=self.numeric[idx],
            labels=None if self.labels is None else self.labels[idx],
        )


@dataclasses.dataclass
class Preprocessor:
    """Fitted preprocessing state. ``fit`` -> ``encode`` -> arrays."""

    numeric_median: np.ndarray  # float32 [num_numeric]
    numeric_mean: np.ndarray  # float32 [num_numeric]
    numeric_std: np.ndarray  # float32 [num_numeric]
    schema_fingerprint: str

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(
        cls, columns: dict[str, list], schema: FeatureSchema = SCHEMA
    ) -> "Preprocessor":
        medians, means, stds = [], [], []
        for feat in schema.numeric:
            raw = np.asarray(columns[feat.name], dtype=np.float64)
            finite = raw[np.isfinite(raw)]
            median = float(np.median(finite)) if finite.size else 0.0
            filled = np.where(np.isfinite(raw), raw, median)
            mean = float(filled.mean()) if filled.size else 0.0
            std = float(filled.std()) if filled.size else 1.0
            medians.append(median)
            means.append(mean)
            stds.append(std if std > 1e-12 else 1.0)
        return cls(
            numeric_median=np.asarray(medians, dtype=np.float32),
            numeric_mean=np.asarray(means, dtype=np.float32),
            numeric_std=np.asarray(stds, dtype=np.float32),
            schema_fingerprint=schema.fingerprint(),
        )

    # --------------------------------------------------------------- encode
    def encode(
        self,
        columns: dict[str, list],
        labels: np.ndarray | None = None,
        schema: FeatureSchema = SCHEMA,
    ) -> EncodedDataset:
        n = len(next(iter(columns.values())))
        cat_ids = np.empty((n, schema.num_categorical), dtype=np.int32)
        for j, feat in enumerate(schema.categorical):
            sorted_vocab, sorted_ids = _vocab_table(feat)
            # Vectorized vocab lookup: binary-search the sorted vocab and
            # verify the hit; misses (unseen value, "", non-string coerced
            # by str()) take the OOV id — same semantics as the dict probe
            # this replaces, at array speed. The column keeps its own
            # string width (casting to the vocab's would truncate long
            # unseen values into false hits).
            raw = np.asarray(columns[feat.name], dtype=np.str_)
            pos = np.minimum(
                np.searchsorted(sorted_vocab, raw), sorted_vocab.size - 1
            )
            cat_ids[:, j] = np.where(
                sorted_vocab[pos] == raw, sorted_ids[pos], feat.oov_id
            )

        numeric = np.empty((n, schema.num_numeric), dtype=np.float32)
        for j, feat in enumerate(schema.numeric):
            raw = np.asarray(columns[feat.name], dtype=np.float32)
            raw = np.where(np.isfinite(raw), raw, self.numeric_median[j])
            numeric[:, j] = (raw - self.numeric_mean[j]) / self.numeric_std[j]

        return EncodedDataset(
            cat_ids=cat_ids,
            numeric=numeric,
            labels=None if labels is None else np.asarray(labels),
        )

    # ------------------------------------------------------------ serialize
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "numeric_median": self.numeric_median,
            "numeric_mean": self.numeric_mean,
            "numeric_std": self.numeric_std,
            "schema_fingerprint": np.frombuffer(
                self.schema_fingerprint.encode(), dtype=np.uint8
            ),
        }

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "Preprocessor":
        return cls(
            numeric_median=np.asarray(arrays["numeric_median"], dtype=np.float32),
            numeric_mean=np.asarray(arrays["numeric_mean"], dtype=np.float32),
            numeric_std=np.asarray(arrays["numeric_std"], dtype=np.float32),
            schema_fingerprint=bytes(
                np.asarray(arrays["schema_fingerprint"], dtype=np.uint8)
            ).decode(),
        )

    def save(self, path: str | Path) -> None:
        np.savez(Path(path).with_suffix(".npz"), **self.to_arrays())

    @classmethod
    def load(cls, path: str | Path) -> "Preprocessor":
        with np.load(Path(path).with_suffix(".npz")) as data:
            return cls.from_arrays({k: data[k] for k in data.files})
