"""Offline subcommands: ``predict-file`` on a ``doc`` bundle.

The JAX package's ``_predict_file`` / ``_predict_documents``
(``mlops_tpu/commands.py:315-384``): consecutive rows of a record-history
CSV group into ``doc_records``-length documents (the prediction targets
the last record's default), documents stream through the doc model in
``serve.max_batch`` chunks (the tail chunk padded to the same shape), and
one calibrated probability ``sigmoid(logit / T)`` comes back per
document, with the grouping accounted for. Runs on the card unless
``serve.device=cpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from mlops_tpu_torch.bundle import Bundle, load_bundle
from mlops_tpu_torch.config import Config
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.data.ingest import load_csv_columns
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.train.long_context import group_documents

# What a non-doc bundle would need from predict-file, by flavor.
_UNPORTED_TIER = {
    "flax": "the exact tier (the zoo's flax models)",
    "sklearn": "the sklearn tree-ensemble floor",
}


def predict_file(config: Config) -> dict:
    """``predict-file data.train_path=<csv> serve.model_directory=<doc
    bundle>``: the JSON the JAX package prints for a doc bundle."""
    device = resolve_device(config.serve.device)
    source = config.data.train_path
    if not source:
        raise SystemExit("pass the input csv via data.train_path=<csv>")
    bundle = load_bundle(config.serve.model_directory)
    if bundle.flavor != "doc":
        tier = _UNPORTED_TIER.get(bundle.flavor, f"the {bundle.flavor!r} flavor")
        raise SystemExit(
            f"predict-file on a {bundle.flavor!r} bundle needs {tier}, which "
            "this package has not ported yet; it scores doc bundles only"
        )
    columns, _ = load_csv_columns(source)
    return predict_documents(
        bundle, bundle.preprocessor.encode(columns), config.serve.max_batch, device
    )


def predict_documents(
    bundle: Bundle,
    ds: EncodedDataset,
    max_batch: int = 256,
    device: str | torch.device | None = None,
) -> dict:
    """Score an encoded record-history dataset with a doc bundle. The
    bundle's model moves to ``device`` (the card unless ``"cpu"``); each
    ``max_batch`` chunk is one forward under ``torch.inference_mode()``."""
    device = resolve_device(device)
    r = bundle.model_config.doc_records
    if ds.cat_ids.shape[0] < r:
        raise SystemExit(
            f"doc bundle needs at least doc_records={r} rows per document; "
            f"file has {ds.cat_ids.shape[0]}"
        )
    cat, num = group_documents(ds.cat_ids, ds.numeric, r)
    docs = cat.shape[0]
    chunk = max(1, min(int(max_batch), docs))
    model = bundle.model.to(device)
    probs = np.empty(docs, np.float32)
    with torch.inference_mode():
        for lo in range(0, docs, chunk):
            hi = min(lo + chunk, docs)
            pad = chunk - (hi - lo)  # pad the tail to the same shape
            c = np.pad(cat[lo:hi], ((0, pad), (0, 0), (0, 0)))
            x = np.pad(num[lo:hi], ((0, pad), (0, 0), (0, 0)))
            logits = model(
                torch.from_numpy(c).to(device), torch.from_numpy(x).to(device)
            )
            probs[lo:hi] = (
                torch.sigmoid(logits / bundle.temperature).cpu().numpy()[: hi - lo]
            )
    return {
        "predictions": [round(float(p), 6) for p in probs],
        "documents": int(docs),
        "records_per_document": r,
        "rows_dropped": int(ds.cat_ids.shape[0] - docs * r),
    }
