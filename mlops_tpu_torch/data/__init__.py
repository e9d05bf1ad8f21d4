"""Encoding, CSV ingest and synthetic data (numpy copies of the JAX
package's)."""

from mlops_tpu_torch.data.encode import EncodedDataset, Preprocessor
from mlops_tpu_torch.data.ingest import load_csv_columns, write_csv_columns
from mlops_tpu_torch.data.synth import generate_synthetic

__all__ = [
    "EncodedDataset",
    "Preprocessor",
    "generate_synthetic",
    "load_csv_columns",
    "write_csv_columns",
]
