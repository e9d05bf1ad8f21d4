"""Canonical feature schema for the credit-default task.

Feature names, ordering, and categorical/numeric split match the reference's
serving contract (`app/model.py:8-34`: 9 categorical string features followed
by 14 numeric features). Categorical vocabularies cover the adapted UCI
Credit Card Default dataset values observed in
`databricks/data/inference.csv` plus the full UCI repayment-delay range, with
out-of-vocabulary handling equivalent to the reference's
`OneHotEncoder(handle_unknown="ignore")` (`01-train-model.ipynb:204-209`):
unseen categories map to a dedicated OOV id instead of failing.

Everything downstream is derived from ``SCHEMA``:

- request validation (``schema.validate``)
- the integer/float encoder layout (``data.encode``)
- embedding-table sizes (``ops.quant``)
- per-feature drift layout (``monitor.state``)

This module is a copy of the JAX package's ``schema/features.py``; the
two must produce the same ``fingerprint()``, which the tests pin, so a
bundle written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class CategoricalFeature:
    """A string-valued feature with a fixed vocabulary.

    Encoded as an int32 id in ``[0, card)``; id ``card - 1`` is the reserved
    out-of-vocabulary bucket (parity with ``handle_unknown="ignore"``).
    """

    name: str
    vocab: tuple[str, ...]
    default: str

    @property
    def card(self) -> int:
        """Cardinality including the OOV bucket."""
        return len(self.vocab) + 1

    @property
    def oov_id(self) -> int:
        return len(self.vocab)

    def encode(self, value: str) -> int:
        try:
            return self.vocab.index(value)
        except ValueError:
            return self.oov_id


@dataclasses.dataclass(frozen=True)
class NumericFeature:
    """A float-valued feature, standardized with train-time mean/std.

    Missing values are imputed with the train-time median (parity with the
    reference's ``SimpleImputer(strategy="median")``,
    `01-train-model.ipynb:195-227`).
    """

    name: str
    default: float


_REPAYMENT_VOCAB: tuple[str, ...] = (
    "duly_paid",
    "no_delay",
    "delay_1_month",
    "delay_2_months",
    "delay_3_months",
    "delay_4_months",
    "delay_5_months",
    "delay_6_months",
    "delay_7_months",
    "delay_8_months",
    "delay_9_months",
)


CATEGORICAL_FEATURES: tuple[CategoricalFeature, ...] = (
    CategoricalFeature("sex", ("male", "female"), "male"),
    CategoricalFeature(
        "education",
        ("graduate_school", "university", "high_school", "others"),
        "university",
    ),
    CategoricalFeature("marriage", ("married", "single", "others"), "married"),
    *(
        CategoricalFeature(
            f"repayment_status_{i}",
            _REPAYMENT_VOCAB,
            "duly_paid" if i <= 4 else "no_delay",
        )
        for i in range(1, 7)
    ),
)

# Numeric defaults follow the reference's LoanApplicant defaults
# (`app/model.py:21-34`) except `age`, whose reference default of 18000.0 is a
# documented copy-paste bug (SURVEY.md SS7 "bugs to not replicate").
NUMERIC_FEATURES: tuple[NumericFeature, ...] = (
    NumericFeature("credit_limit", 18000.0),
    NumericFeature("age", 35.0),
    NumericFeature("bill_amount_1", 764.95),
    NumericFeature("bill_amount_2", 2221.95),
    NumericFeature("bill_amount_3", 1131.85),
    NumericFeature("bill_amount_4", 5074.85),
    NumericFeature("bill_amount_5", 18000.0),
    NumericFeature("bill_amount_6", 1419.95),
    NumericFeature("payment_amount_1", 2236.5),
    NumericFeature("payment_amount_2", 1137.55),
    NumericFeature("payment_amount_3", 5084.55),
    NumericFeature("payment_amount_4", 111.65),
    NumericFeature("payment_amount_5", 306.9),
    NumericFeature("payment_amount_6", 805.65),
)

TARGET = "default_payment_next_month"


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    """The full feature contract: ordered categorical + numeric features."""

    categorical: tuple[CategoricalFeature, ...]
    numeric: tuple[NumericFeature, ...]
    target: str

    @property
    def feature_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.categorical) + tuple(
            f.name for f in self.numeric
        )

    @property
    def num_categorical(self) -> int:
        return len(self.categorical)

    @property
    def num_numeric(self) -> int:
        return len(self.numeric)

    @property
    def num_features(self) -> int:
        return self.num_categorical + self.num_numeric

    @property
    def cards(self) -> tuple[int, ...]:
        """Embedding-table cardinalities (incl. OOV bucket) per categorical."""
        return tuple(f.card for f in self.categorical)

    def fingerprint(self) -> str:
        """Stable content hash used in bundle manifests for compat checks."""
        payload = json.dumps(
            {
                "categorical": [[f.name, list(f.vocab)] for f in self.categorical],
                "numeric": [f.name for f in self.numeric],
                "target": self.target,
            },
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


SCHEMA = FeatureSchema(
    categorical=CATEGORICAL_FEATURES,
    numeric=NUMERIC_FEATURES,
    target=TARGET,
)

FEATURE_NAMES = SCHEMA.feature_names
NUM_CATEGORICAL = SCHEMA.num_categorical
NUM_NUMERIC = SCHEMA.num_numeric
NUM_FEATURES = SCHEMA.num_features
