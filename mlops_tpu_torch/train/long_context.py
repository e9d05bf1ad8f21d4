"""Long-context documents: grouping rows into record histories and
building the dense doc model (the JAX package's ``train/long_context.py``,
inference half). The sequence-parallel ring and the train step are not
ported yet."""

from __future__ import annotations

import numpy as np
import torch

from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.models.bert import BertDocEncoder
from mlops_tpu_torch.schema.features import SCHEMA

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def group_documents(
    cat_ids: np.ndarray, numeric: np.ndarray, doc_records: int
) -> tuple[np.ndarray, np.ndarray]:
    """Group consecutive encoded rows into record histories:
    ``[N,C]`` -> ``[D,R,C]``. Rows past the last full document drop."""
    docs = cat_ids.shape[0] // doc_records
    take = docs * doc_records
    cat = cat_ids[:take].reshape(docs, doc_records, -1)
    num = numeric[:take].reshape(docs, doc_records, -1)
    return cat, num


def build_doc_model(config: ModelConfig) -> BertDocEncoder:
    """The dense ``BertDocEncoder`` of ``config``, on the CPU with zero
    weights (load a bundle's params or ``init_doc_params`` into it).
    Dropout is 0, as in the JAX package's ``build_doc_model``;
    ``seq_parallel=true`` (the ring) is refused: it is not ported."""
    if config.seq_parallel:
        raise ValueError(
            "model.seq_parallel=true (ring attention over a 'seq' mesh axis) "
            "is not ported; the port builds the dense doc model only"
        )
    if config.precision not in DTYPES:
        raise ValueError(f"unknown precision {config.precision!r}")
    return BertDocEncoder(
        cards=SCHEMA.cards,
        num_numeric=SCHEMA.num_numeric,
        doc_records=config.doc_records,
        hidden=config.token_dim,
        depth=config.depth,
        heads=config.heads,
        dtype=DTYPES[config.precision],
    )
