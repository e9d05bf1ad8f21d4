"""Offline subcommands: ``train`` and ``predict-file`` on a ``flax``
(exact tier) or ``doc`` bundle.

``train`` is the JAX package's ``_train`` (``mlops_tpu/commands.py:96``):
``run_layout_training`` for a layout config (the long-context doc model),
else ``run_training`` (the exact tier's dense trainer), on
``train.device`` (the card unless ``cpu``), then the same JSON line. ``predict-file`` is the JAX
package's ``_predict_file`` / ``_predict_documents``
(``mlops_tpu/commands.py:315-384``). On a ``flax`` bundle it is one
exact-tier engine dispatch over the whole file (``buckets=(max_batch,)``,
``predict_arrays``), printing the response JSON. On a ``doc`` bundle,
consecutive rows of a record-history
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
from mlops_tpu_torch.train.long_context import check_doc_attention, group_documents


def train(config: Config) -> dict:
    """``train --config <toml> [overrides]``: the JSON the JAX package
    prints (bundle, model_uri, run_dir, steps, packaged_step, metrics)."""
    from mlops_tpu_torch.train.pipeline import run_layout_training, run_training

    run = run_layout_training if config.model.uses_layout_trainer else run_training
    result = run(config, run_name=config.registry.run_name or None)
    return {
        "bundle": str(result.bundle_dir) if result.bundle_dir else None,
        "model_uri": result.model_uri,
        "run_dir": str(result.run_dir),
        "steps": result.train_result.steps,
        "packaged_step": result.train_result.packaged_step,
        "metrics": result.train_result.metrics,
    }


def predict_file(config: Config) -> dict:
    """``predict-file data.train_path=<csv> serve.model_directory=<bundle>``:
    the JSON the JAX package prints for a flax or a doc bundle."""
    from mlops_tpu_torch.serve.engine import InferenceEngine

    device = resolve_device(config.serve.device)
    source = config.data.train_path
    if not source:
        raise SystemExit("pass the input csv via data.train_path=<csv>")
    bundle = load_bundle(config.serve.model_directory)
    if bundle.flavor == "sklearn":
        raise SystemExit(
            "predict-file on a 'sklearn' bundle needs the sklearn "
            "tree-ensemble floor (ROADMAP A8), which this package has not "
            "ported yet"
        )
    columns, _ = load_csv_columns(source)
    ds = bundle.preprocessor.encode(columns)
    if bundle.flavor == "doc":
        return predict_documents(bundle, ds, config.serve.max_batch, device)
    try:
        engine = InferenceEngine(
            bundle, buckets=(config.serve.max_batch,), serve_tier="exact",
            device=device,
        )
    except ValueError as err:
        raise SystemExit(f"predict-file scores a flax bundle on its exact tier: {err}") from err
    return engine.predict_arrays(ds.cat_ids, ds.numeric)


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
    check_doc_attention(bundle.model_config, device)
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
