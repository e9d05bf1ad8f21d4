"""Offline subcommands: ``train``, ``pretrain``, ``tune``, ``predict-file`` on a
``flax`` (exact tier), ``sklearn`` or ``doc`` bundle, ``score-batch``, ``warmup``, the
registry's ``register`` / ``promote`` / ``versions`` / ``gc``, ``synth``
and ``validate``.

``warmup`` is the JAX package's ``_warmup`` (``mlops_tpu/commands.py:689``)
for the port's artifacts, the kernel libraries (``compilecache/``): with
``cache.dir`` set (``--cache-dir``), it builds the libraries the resolved
bundle's serving programs launch into ``<cache.dir>/kernels/``, or every
library when no bundle resolves (said on stderr), and returns the report.

``train`` is the JAX package's ``_train`` (``mlops_tpu/commands.py:96``):
``run_layout_training`` for a layout config (tensor- or pipeline-
parallel training, the long-context doc model with or without the ring),
else ``run_training`` (the exact tier's dense trainer; a bert fine-tune
from a pretrained trunk with ``train.init_params``), on
``train.device`` (the card unless ``cpu``), then the same JSON line.
``pretrain`` is the JAX package's ``_pretrain``
(``mlops_tpu/commands.py:123``): masked-feature pretraining of the bert
trunk on unlabeled rows (``train/pretrain.py``), written to
``<run_dir>/pretrained.msgpack``. ``predict-file`` is the JAX
package's ``_predict_file`` / ``_predict_documents``
(``mlops_tpu/commands.py:315-384``). On a ``flax`` bundle it is one
exact-tier engine dispatch over the whole file (``buckets=(max_batch,)``,
``predict_arrays``), printing the response JSON; an ``sklearn`` bundle
runs the same dispatch on its gbm tier, or on the rf host hybrid. On a ``doc`` bundle,
consecutive rows of a record-history
CSV group into ``doc_records``-length documents (the prediction targets
the last record's default), documents stream through the doc model in
``serve.max_batch`` chunks (the tail chunk padded to the same shape), and
one calibrated probability ``sigmoid(logit / T)`` comes back per
document, with the grouping accounted for. ``score-batch`` is the JAX
package's ``_score_batch`` (``mlops_tpu/commands.py:387``):
``parallel/bulk.py score_dataset`` over ``data.train_path`` (a CSV or a
Parquet file) or ``data.rows`` synthetic rows, or with
``score.streaming=true`` ``data/stream.py score_csv_stream`` from the
file to ``score.output_path``. Each runs on the card unless
``serve.device=cpu``. Every data path and ``registry.root`` may be a
``gs://`` URI, as in the JAX package.
``serve``, ``predict-file`` and ``score-batch`` take
``serve.model_directory`` as a bundle directory or, when it is not one,
as a version number, a stage or ``latest`` of ``registry.model_name`` in
the registry at ``registry.root`` (``resolve_bundle``, the JAX package's
``_resolve_bundle``).

``lifecycle`` is the JAX package's ``_lifecycle``
(``mlops_tpu/commands.py:736``), the offline twin of the serving loop:
the incumbent bundle (``serve.model_directory``) and the labeled window
(``lifecycle.labeled_path``) -> a fine-tuned candidate (on
``train.device``) -> both sides scored through their serving programs on
``serve.device`` -> the AUC and calibration gates (no mirrored traffic
offline, so the latency gate passes) -> registered when they pass.

``tune`` is the JAX package's ``_tune`` (``mlops_tpu/commands.py:151``):
``train/pipeline.py run_tuning`` and the same JSON line; with more than
one rank (``torch.distributed.run``, ``parallel/distributed.py``) the
trials split over a data mesh of the world, as the JAX command shards
them over every chip, and ``score-batch`` and the streamed scorer split
each chunk's rows the same way (``devices``, ``mesh`` in the JSON).
The registry commands, ``synth`` and ``validate`` are the JAX package's
(``mlops_tpu/commands.py:86,174-312``), with its outputs and exit codes.
"""

from __future__ import annotations


import numpy as np
import torch

from mlops_tpu_torch.bundle import Bundle, load_bundle
from mlops_tpu_torch.bundle.registry import ModelRegistry, resolve_bundle
from mlops_tpu_torch.config import Config
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.data.ingest import load_csv_columns, load_table_columns
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


def pretrain(config: Config) -> dict:
    """``pretrain --config <toml> [overrides]``: masked-feature
    pretraining on ``train.device`` with the JAX package's checks and data
    sources (``data.train_path`` or ``data.rows`` synthetic rows; labels
    are never read); the JSON it prints (pretrained, rows, loss_curve)."""
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.train.pipeline import new_run_dir
    from mlops_tpu_torch.train.pretrain import (
        PRETRAINED_NAME,
        pretrain_bert,
        save_pretrained,
    )

    if config.model.family != "bert":
        raise SystemExit("pretrain supports model.family=bert")
    if config.model.uses_layout_trainer:
        raise SystemExit(
            "pretrain runs the dense single-record masked-LM; unset the "
            "layout knobs (model.pipeline_stages / seq_parallel / "
            "doc_records>1)"
        )
    if config.data.train_path:
        columns, _ = load_table_columns(config.data.train_path)
    else:
        columns, _ = generate_synthetic(config.data.rows, seed=config.data.seed)
    ds = Preprocessor.fit(columns).encode(columns)
    result = pretrain_bert(
        config.model,
        ds,
        steps=config.train.steps,
        batch_size=config.train.batch_size,
        learning_rate=config.train.learning_rate,
        seed=config.train.seed,
        device=config.train.device,
    )
    out = new_run_dir(config) / PRETRAINED_NAME
    save_pretrained(result, out)
    return {"pretrained": str(out), "rows": ds.n, "loss_curve": result.losses}


def lifecycle(config: Config) -> tuple[dict, bool]:
    """One offline lifecycle pass; returns the JAX command's JSON record
    and whether the gates passed. A window that cannot produce a
    candidate exits with its reason."""
    from mlops_tpu_torch.lifecycle import promote
    from mlops_tpu_torch.lifecycle.retrain import LifecycleError, run_retrain
    from mlops_tpu_torch.lifecycle.shadow import ShadowEngine
    from mlops_tpu_torch.serve.engine import InferenceEngine

    incumbent = load_bundle(resolve_bundle(config))
    try:
        result = run_retrain(incumbent, config, generation=2)
    except LifecycleError as err:
        raise SystemExit(f"lifecycle: {err}") from err
    live = InferenceEngine(
        incumbent,
        buckets=tuple(config.serve.warmup_batch_sizes),
        device=config.serve.device,
    )
    shadow = ShadowEngine(live, result.bundle)
    shadow.warm()
    report = shadow.evaluate(result.holdout, result.holdout_incumbent)
    decision = promote.evaluate_gates(report, config.lifecycle)
    model_uri = None
    if decision.passed and config.lifecycle.auto_promote:
        model_uri = ModelRegistry(config.registry.root).register(
            config.registry.model_name,
            result.candidate_dir,
            tags={"lifecycle": "gated-promotion"},
        )
    return {
        "candidate": str(result.candidate_dir),
        "labeled_rows": result.labeled_rows,
        "retrain_wall_s": result.wall_s,
        "auc_candidate": round(report.auc_candidate, 6),
        "auc_incumbent": round(report.auc_incumbent, 6),
        "auc_delta": round(report.auc_delta, 6),
        "ece_candidate": round(report.ece_candidate, 6),
        "gates": decision.as_dict(),
        "model_uri": model_uri,
    }, decision.passed


def tune(config: Config) -> dict:
    """``tune --config <toml> [overrides]``: the JSON the JAX package
    prints (bundle, model_uri, best_trial, best_hyperparams, metrics,
    trials)."""
    from mlops_tpu_torch.train.pipeline import run_tuning

    result, hpo_result = run_tuning(
        config, run_name=config.registry.run_name or None,
        mesh=_data_mesh(config.train.device),
    )
    return {
        "bundle": str(result.bundle_dir),
        "model_uri": result.model_uri,
        "best_trial": hpo_result.best_index,
        "best_hyperparams": hpo_result.best_hyperparams,
        "metrics": hpo_result.best_metrics,
        "trials": len(hpo_result.trials),
    }


def _data_mesh(device: str):
    """A data mesh over the world's ranks when there is more than one (the
    group joined here over the device's backend), else None: the JAX
    command's ``make_mesh(device_count) if device_count > 1``."""
    from mlops_tpu_torch.parallel.distributed import initialize, world_size
    from mlops_tpu_torch.parallel.mesh import make_mesh

    if world_size() < 2:
        return None
    initialize(device)
    return make_mesh()


def warmup(config: Config) -> dict:
    """``warmup --cache-dir <dir>``: the kernel libraries into the cache,
    ``cache.warmup_workers`` nvcc builds at a time; needs nvcc, no card."""
    from mlops_tpu_torch.ops import cuda_build

    if not config.cache.dir:
        raise SystemExit("pass --cache-dir <dir> (or cache.dir=<dir>)")
    # The cache directory is the process's; a caller in process (a test,
    # a notebook) gets its own back on return.
    previous = cuda_build.cache_dir()
    cuda_build.set_cache_dir(config.cache.dir)
    try:
        return _warm_cache(config)
    finally:
        cuda_build.set_cache_dir(previous)


def _warm_cache(config: Config) -> dict:
    import os
    import sys

    from mlops_tpu_torch.compilecache import (
        bundle_libraries,
        gbm_serve_entries,
        libraries,
        warm_kernels,
    )

    model_dir = os.environ.get("MODEL_DIRECTORY", config.serve.model_directory)
    try:
        bundle_dir = resolve_bundle(config, model_dir)
    # No bundle anywhere (an image built before training): every library
    # is built, and said so, as the JAX package's config-mode warmup does.
    except Exception as err:  # tpulint: disable=TPU201
        print(f"warmup: no bundle at {model_dir!r} ({err}); building every "
              f"kernel library ({', '.join(libraries())})", file=sys.stderr)
        bundle_dir = None
    bundle = None
    if bundle_dir is None:
        names = list(libraries())
    else:
        # A bundle that resolves but does not load fails the build.
        bundle = load_bundle(bundle_dir)
        names = bundle_libraries(bundle, config.serve.serve_tier,
                                 config.serve.tier_routing)
    report = warm_kernels(names, config.cache.warmup_workers)
    gbm = gbm_serve_entries(bundle, tuple(config.serve.warmup_batch_sizes),
                            grouping=config.serve.batch_window_ms > 0)
    if gbm is not None:
        # No library serves the gbm tier: its programs are captured into
        # graphs at each engine's warmup, listed here as the JAX report does.
        report["gbm_entries"] = gbm
    return {"bundle": None if bundle_dir is None else str(bundle_dir), **report}


def register(config: Config) -> str:
    """``register data.train_path=<bundle dir>``: the new version's URI."""
    bundle_dir = config.data.train_path
    if not bundle_dir:
        raise SystemExit("pass the bundle dir via data.train_path=<dir>")
    return ModelRegistry(config.registry.root).register(config.registry.model_name, bundle_dir)


def promote(config: Config) -> dict:
    """``promote registry.promote_version=<n> registry.promote_stage=<stage>``:
    the registry half of the staging -> production gate."""
    version = config.registry.promote_version
    stage = config.registry.promote_stage
    if not version:
        raise SystemExit(
            "pass registry.promote_version=<n> [registry.promote_stage=staging]"
        )
    ModelRegistry(config.registry.root).set_stage(config.registry.model_name, int(version), stage)
    return {"model": config.registry.model_name, "version": int(version), "stage": stage}


def versions(config: Config) -> list[dict]:
    return ModelRegistry(config.registry.root).list_versions(config.registry.model_name)


def gc(config: Config) -> dict:
    """Prune crash orphans (and, with ``registry.gc_keep=N``, old unstaged
    versions) of the configured model."""
    try:
        removed = ModelRegistry(config.registry.root).gc(
            config.registry.model_name, keep_unstaged=config.registry.gc_keep
        )
    except ValueError as err:  # a gs:// root: a message, no traceback
        raise SystemExit(str(err)) from err
    return {"model": config.registry.model_name, **removed}


def synth(config: Config) -> str:
    """Write ``data.rows`` synthetic rows from ``data.seed`` to
    ``data.train_path`` (``data/curated.csv`` when unset)."""
    from mlops_tpu_torch.data import generate_synthetic, write_csv_columns

    path = config.data.train_path or "data/curated.csv"
    columns, labels = generate_synthetic(config.data.rows, seed=config.data.seed)
    write_csv_columns(path, columns, labels)
    return f"wrote {config.data.rows} rows -> {path}"


def validate(config: Config) -> dict:
    """Lint a CSV or Parquet file before training or scoring, streamed:
    values the pipeline would silently degrade (out-of-vocabulary
    categoricals, missing or unparseable numerics) and the labels' parse
    as training sees it. ``ok`` is False when anything is flagged."""
    from mlops_tpu_torch.data.stream import iter_table_chunks
    from mlops_tpu_torch.schema import SCHEMA

    path = config.data.train_path
    if not path:
        raise SystemExit("pass the dataset via data.train_path=<csv|parquet>")
    rows = 0
    oov = dict.fromkeys((f.name for f in SCHEMA.categorical), 0)
    vocabs = {f.name: set(f.vocab) for f in SCHEMA.categorical}
    degraded_numeric = dict.fromkeys((f.name for f in SCHEMA.numeric), 0)
    for columns, _ in iter_table_chunks(path, chunk_rows=65_536):
        rows += len(columns[SCHEMA.categorical[0].name])
        for feat in SCHEMA.categorical:
            vocab = vocabs[feat.name]
            oov[feat.name] += sum(1 for v in columns[feat.name] if v not in vocab)
        for feat in SCHEMA.numeric:
            raw = np.asarray(columns[feat.name], dtype=np.float64)
            degraded_numeric[feat.name] += int((~np.isfinite(raw)).sum())
    # Label pre-flight: training's strict parse (one bad value fails
    # `train` fast); "absent" is fine for scoring-only files.
    try:
        for _ in iter_table_chunks(path, chunk_rows=65_536, require_target=True):
            pass
        labels = "ok"
    except ValueError as err:
        labels = "absent" if "missing target column" in str(err) else str(err)
    return {
        "path": path,
        "rows": rows,
        "oov_categorical": {k: v for k, v in oov.items() if v},
        "numeric_imputed": {k: v for k, v in degraded_numeric.items() if v},
        "labels": labels,
        "ok": (
            not any(oov.values())
            and not any(degraded_numeric.values())
            and labels in ("ok", "absent")
        ),
    }


def predict_file(config: Config) -> dict:
    """``predict-file data.train_path=<csv> serve.model_directory=<bundle>``:
    the JSON the JAX package prints for a flax, an sklearn (the gbm tier,
    or the rf host hybrid) or a doc bundle."""
    from mlops_tpu_torch.serve.engine import InferenceEngine

    device = resolve_device(config.serve.device)
    source = config.data.train_path
    if not source:
        raise SystemExit("pass the input csv via data.train_path=<csv>")
    bundle = load_bundle(resolve_bundle(config))
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


def score_batch(config: Config) -> dict:
    """``score-batch serve.model_directory=<bundle> [data.rows=N |
    data.train_path=<csv|parquet>] [score.*]``: the JSON the JAX package
    prints (``devices`` the world size, ``mesh`` the data mesh's shape,
    ``[1]`` on one rank); ``score.output_path`` writes the predictions and
    outliers as an ``.npz`` (the coordinator). With
    ``score.streaming=true`` the file streams to ``score.output_path`` (a
    CSV) and the stream's stats are printed."""
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.parallel.bulk import DOC_REFUSAL, score_dataset
    from mlops_tpu_torch.parallel.distributed import (
        is_coordinator,
        rank_device,
        world_size,
    )

    device = rank_device(config.serve.device)
    mesh = _data_mesh(config.serve.device)
    bundle = load_bundle(resolve_bundle(config))
    if bundle.flavor == "doc":
        raise SystemExit(DOC_REFUSAL)
    exact = True if config.score.exact else None
    if config.score.streaming:
        from mlops_tpu_torch.data.stream import score_csv_stream

        if not config.data.train_path:
            raise SystemExit("score.streaming requires data.train_path=<csv>")
        return score_csv_stream(
            bundle,
            config.data.train_path,
            out_path=config.score.output_path or None,
            chunk_rows=config.score.chunk_rows,
            exact=exact,
            pipeline_depth=config.score.pipeline_depth,
            device=device,
            mesh=mesh,
        )
    if config.data.train_path:
        # Both formats encode through the Python pipeline (the JAX package
        # takes it for Parquet; its C++ CSV encoder is pinned equal to it).
        columns, _ = load_table_columns(config.data.train_path)
    else:
        columns, _ = generate_synthetic(config.data.rows, seed=config.data.seed)
    ds = bundle.preprocessor.encode(columns)
    result = score_dataset(
        bundle,
        ds,
        chunk_rows=config.score.chunk_rows,
        drift_sample=config.score.drift_sample,
        seed=config.data.seed,
        exact=exact,
        pipeline_depth=config.score.pipeline_depth,
        device=device,
        mesh=mesh,
    )
    if config.score.output_path and is_coordinator():
        np.savez(
            config.score.output_path,
            predictions=result.predictions,
            outliers=result.outliers,
        )
    return {
        "devices": world_size(),
        "mesh": mesh.describe() if mesh is not None else [1],
        **result.summary(),
    }
