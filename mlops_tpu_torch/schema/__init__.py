"""Feature schema and request validation (the port's own copies)."""

from mlops_tpu_torch.schema.features import (
    FEATURE_NAMES,
    NUM_CATEGORICAL,
    NUM_FEATURES,
    NUM_NUMERIC,
    SCHEMA,
)
from mlops_tpu_torch.schema.validate import records_to_columns, validate_records

__all__ = [
    "FEATURE_NAMES",
    "NUM_CATEGORICAL",
    "NUM_FEATURES",
    "NUM_NUMERIC",
    "SCHEMA",
    "records_to_columns",
    "validate_records",
]
