"""Out-of-core streaming: chunked ingest and stream scoring.

Port of the JAX package's ``data/stream.py`` scoring half: a CSV or
Parquet file of any size, local or ``gs://`` (staged by
``ingest.fetch_local``), is read as fixed-size row chunks and scored
chunk -> encode -> device -> append-to-output without ever holding the
dataset. CSV chunks share the batch reader's parsing (``data/ingest.py``
``rows_to_columns`` / ``parse_labels``): blank lines skipped, short rows
read missing cells as empty (-> OOV / median); labels are parsed,
strictly, only under ``require_target=True``. Parquet chunks come from
``parquet.iter_parquet_chunks`` with the same contract.

The streaming preprocessor fit is here too (``StreamingStats``,
``fit_streaming``: one pass, shifted moments and a seeded per-feature
reservoir for the medians, bit-identical to the JAX package's), which the
lifecycle retrain uses under ``lifecycle.refit_preprocessor=true``.

Not ported: the C++ byte-level encoder (``native/``): chunks encode
through the Python route, which the JAX package pins bit-identical to it.
"""

from __future__ import annotations

import contextlib
import csv
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from mlops_tpu_torch.data.encode import Preprocessor
from mlops_tpu_torch.data.ingest import fetch_local, parse_labels, rows_to_columns
from mlops_tpu_torch.schema.features import SCHEMA, FeatureSchema


def iter_csv_chunks(
    path: str | Path,
    chunk_rows: int = 65_536,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> Iterator[tuple[dict[str, list], np.ndarray | None]]:
    """Yield ``(columns, labels)`` chunks of at most ``chunk_rows`` rows;
    ``labels`` is None unless ``require_target``. Memory is bounded by one
    chunk. Accepts local paths and ``gs://`` URIs."""
    with fetch_local(path).open(newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        col_index = {name: i for i, name in enumerate(header)}
        missing = [n for n in schema.feature_names if n not in col_index]
        if missing:
            raise ValueError(f"{path}: missing required columns {missing}")
        if require_target and schema.target not in col_index:
            raise ValueError(f"{path}: missing target column {schema.target!r}")

        def emit(rows: list, base_row: int):
            columns = rows_to_columns(rows, col_index, schema)
            labels = (
                parse_labels(rows, col_index, schema, path, base_row)
                if require_target
                else None
            )
            return columns, labels

        buffer: list = []
        seen = 0
        for row in reader:
            if not row or row == [""]:
                continue
            buffer.append(row)
            if len(buffer) >= chunk_rows:
                yield emit(buffer, seen)
                seen += len(buffer)
                buffer = []
        if buffer:
            yield emit(buffer, seen)


def iter_table_chunks(
    path: str | Path,
    chunk_rows: int = 65_536,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> Iterator[tuple[dict[str, list], np.ndarray | None]]:
    """The JAX package's format-dispatching chunk iterator: Parquet
    streams through ``parquet.iter_parquet_chunks`` (chunks of exactly
    ``chunk_rows`` rows but the tail), anything else through
    ``iter_csv_chunks``. Same yielded contract."""
    from mlops_tpu_torch.data import parquet

    if parquet.is_parquet(path):
        return parquet.iter_parquet_chunks(path, chunk_rows, schema, require_target)
    return iter_csv_chunks(path, chunk_rows, schema, require_target)


class StreamingStats:
    """Mergeable single-pass accumulator for the Preprocessor's fit.

    ``update(columns)`` per chunk, then ``finalize()`` -> Preprocessor.
    """

    def __init__(
        self,
        schema: FeatureSchema = SCHEMA,
        reservoir_size: int = 100_000,
        seed: int = 0,
    ):
        self.schema = schema
        m = schema.num_numeric
        self._count = np.zeros(m, np.int64)  # finite values
        self._missing = np.zeros(m, np.int64)
        self._shift = np.full(m, np.nan)  # first finite value per feature
        self._sum_d = np.zeros(m, np.float64)  # sum of (x - shift)
        self._sumsq_d = np.zeros(m, np.float64)  # sum of (x - shift)^2
        self._reservoirs: list[np.ndarray] = [
            np.empty(0, np.float64) for _ in range(m)
        ]
        self._reservoir_size = reservoir_size
        self._rng = np.random.default_rng(seed)

    def update(self, columns: dict[str, list]) -> None:
        self.update_arrays(
            [
                np.asarray(columns[feat.name], dtype=np.float64)
                for feat in self.schema.numeric
            ]
        )

    def update_arrays(self, raws: list[np.ndarray]) -> None:
        """Fold one chunk given per-numeric-feature float64 arrays (in
        schema order). The list-of-columns conversion is split out so the
        pipelined fit (`fit_streaming`) can run it on a worker thread
        while this fold — which must stay sequential for the reservoir
        RNG — runs on the sink."""
        for j, raw in enumerate(raws):
            finite = raw[np.isfinite(raw)]
            self._missing[j] += raw.size - finite.size
            if finite.size and np.isnan(self._shift[j]):
                self._shift[j] = finite[0]
            if finite.size:
                d = finite - self._shift[j]
                self._sum_d[j] += d.sum()
                self._sumsq_d[j] += np.square(d).sum()
            self._reservoirs[j] = self._fold_reservoir(
                self._reservoirs[j], finite, self._count[j]
            )
            self._count[j] += finite.size

    def _fold_reservoir(
        self, reservoir: np.ndarray, values: np.ndarray, seen: int
    ) -> np.ndarray:
        """Uniform reservoir over the stream: every value seen so far has
        equal probability of residing in the sample (Vitter's Algorithm R,
        vectorized per chunk)."""
        k = self._reservoir_size
        if reservoir.size < k:
            taken = min(k - reservoir.size, values.size)
            reservoir = np.concatenate([reservoir, values[:taken]])
            values = values[taken:]
            seen += taken
        if values.size == 0:
            return reservoir
        # For the i-th remaining value (global index seen+i), replace a
        # random slot with probability k / (seen+i+1).
        idx = seen + 1 + np.arange(values.size, dtype=np.float64)
        accept = self._rng.random(values.size) < (k / idx)
        slots = self._rng.integers(0, k, size=values.size)
        sel_slots = slots[accept]
        if sel_slots.size:
            # Vectorized scatter with explicit last-write-wins on duplicate
            # slots (bit-identical to the per-value loop it replaces):
            # np.unique over the REVERSED slot array returns, per unique
            # slot, the index of its last occurrence in stream order.
            sel_values = values[accept]
            unique_slots, last_in_reversed = np.unique(
                sel_slots[::-1], return_index=True
            )
            reservoir[unique_slots] = sel_values[::-1][last_in_reversed]
        return reservoir

    def finalize(self) -> Preprocessor:
        medians, means, stds = [], [], []
        for j in range(self.schema.num_numeric):
            reservoir = self._reservoirs[j]
            median = float(np.median(reservoir)) if reservoir.size else 0.0
            n = self._count[j] + self._missing[j]
            if n == 0:
                means.append(0.0)
                stds.append(1.0)
                medians.append(median)
                continue
            shift = self._shift[j] if np.isfinite(self._shift[j]) else 0.0
            med_d = median - shift
            mean_d = (self._sum_d[j] + self._missing[j] * med_d) / n
            ex2_d = (self._sumsq_d[j] + self._missing[j] * med_d**2) / n
            mean = shift + mean_d
            var = max(ex2_d - mean_d**2, 0.0)
            std = float(np.sqrt(var))
            medians.append(median)
            means.append(float(mean))
            stds.append(std if std > 1e-12 else 1.0)
        return Preprocessor(
            numeric_median=np.asarray(medians, np.float32),
            numeric_mean=np.asarray(means, np.float32),
            numeric_std=np.asarray(stds, np.float32),
            schema_fingerprint=self.schema.fingerprint(),
        )


def fit_streaming(
    path: str | Path,
    chunk_rows: int = 65_536,
    schema: FeatureSchema = SCHEMA,
    reservoir_size: int = 100_000,
    seed: int = 0,
    pipeline_depth: int = 1,
) -> Preprocessor:
    """One-pass Preprocessor fit over an arbitrarily large CSV/Parquet.

    ``pipeline_depth > 1`` overlaps chunk read+parse and the list->float64
    conversion with the sequential moment/reservoir fold on background
    threads (`data/pipeline_exec.py`); depth 1 is the serial loop. The
    fold order is preserved either way, so the fitted Preprocessor is
    bit-identical at any depth.
    """
    from mlops_tpu_torch.data.pipeline_exec import Stage, run_pipeline

    stats = StreamingStats(schema, reservoir_size=reservoir_size, seed=seed)
    names = [feat.name for feat in schema.numeric]

    def to_float_arrays(item):
        columns, _ = item
        return [np.asarray(columns[name], dtype=np.float64) for name in names]

    run_pipeline(
        iter_table_chunks(path, chunk_rows, schema),
        [Stage("tofloat", to_float_arrays)],
        stats.update_arrays,
        depth=pipeline_depth,
        sink_name="fold",
    )
    return stats.finalize()


def score_csv_stream(
    bundle,
    in_path: str | Path,
    out_path: str | Path | None = None,
    chunk_rows: int = 65_536,
    exact: bool | None = None,
    pipeline_depth: int = 2,
    device: str | torch.device | None = None,
    mesh=None,
) -> dict[str, float]:
    """Stream-score a CSV or Parquet file through the bundle's bulk chunk program on
    ``device`` (the card unless "cpu"); on a data ``mesh`` each rank
    scores its block of every chunk and only the coordinator writes
    ``out_path``.

    Stages (``data/pipeline_exec.py``): read and parse -> encode and pad
    -> transfer -> compute -> batched fetch -> append ``prediction,
    outlier`` rows (the prediction rounded to 6 places) to ``out_path``.
    Depth 1 runs them serially with the same output. Returns aggregate
    stats with per-stage busy time and ``rows_per_s`` after warm-up.

    The output is written to a ``.tmp`` sibling and renamed into place on
    success only, so a failure mid-stream (which drains the pipeline and
    propagates) leaves no partial file behind."""
    from mlops_tpu_torch.data.pipeline_exec import Stage, run_pipeline
    from mlops_tpu_torch.device import resolve_device
    from mlops_tpu_torch.parallel.bulk import (
        FETCH_WAVE,
        ChunkFetch,
        make_chunk_scorer,
        make_chunk_transfer,
        mesh_chunk_rows,
    )

    from mlops_tpu_torch.parallel.distributed import is_coordinator

    device = resolve_device(device)
    chunk_rows = mesh_chunk_rows(chunk_rows, mesh)
    if not is_coordinator():
        out_path = None
    # exact=None routes through the distilled student on the CPU when the
    # bundle carries one; the stats' "path" says which ran.
    scorer = make_chunk_scorer(bundle, exact=exact, device=device, mesh=mesh)
    source = (columns for columns, _ in iter_table_chunks(in_path, chunk_rows))
    # An sklearn bundle's chunks stay on the host with int32 ids
    # (``parallel/bulk.py SklearnChunkScorer``). On a mesh this rank
    # encodes, copies and scores only its block of every chunk; the scorer
    # gathers the whole chunk's results.
    block = scorer.block(chunk_rows)
    block_rows = block.stop - block.start
    transfer = make_chunk_transfer(scorer.stage_device, block_rows, pipeline_depth)
    fetch = ChunkFetch(scorer.stage_device, chunk_rows)
    ids = scorer.ids_dtype
    # Warm the chunk program before the streamed (and timed) run.
    fetch([scorer(transfer(
        np.zeros((block_rows, SCHEMA.num_categorical), ids),
        np.zeros((block_rows, SCHEMA.num_numeric), np.float32),
        np.arange(block_rows) < 1,
    ))])

    prep = bundle.preprocessor
    base_index = np.arange(block_rows)
    full_mask = np.ones(block_rows, bool)

    def encode_chunk(columns):
        n = len(next(iter(columns.values())))  # the chunk's rows, every rank's
        if block_rows < chunk_rows:
            columns = {k: v[block] for k, v in columns.items()}
        ds = prep.encode(columns)
        # The ids travel as int8 (the largest vocabulary is 12; an sklearn
        # bundle's as int32); pad to the fixed block shape (only the tail
        # chunk is short).
        cat = ds.cat_ids.astype(ids)
        pad = block_rows - ds.n
        if pad:
            cat = np.pad(cat, ((0, pad), (0, 0)))
            num = np.pad(ds.numeric, ((0, pad), (0, 0)))
            mask = base_index < ds.n
        else:
            num = ds.numeric
            mask = full_mask
        return cat, num, mask, n

    def transfer_chunk(item):
        cat, num, mask, n = item
        return transfer(cat, num, mask), n

    def compute_chunk(item):
        on_device, n = item
        return scorer(on_device), n

    def fetch_chunks(items):
        fetched = fetch([out for out, _ in items])
        return [(host[0, :n], host[1, :n]) for host, (_, n) in zip(fetched, items)]

    rows = 0
    outlier_count = 0.0
    prob_sum = 0.0
    writer = None

    def write_chunk(item):
        nonlocal rows, outlier_count, prob_sum
        probs, outliers = item
        rows += probs.size
        outlier_count += float(outliers.sum())
        prob_sum += float(probs.sum())
        if writer is not None:
            writer.writerows(zip(np.round(probs, 6).tolist(), outliers.tolist()))

    tmp_path = None
    try:
        with contextlib.ExitStack() as stack:
            if out_path is not None:
                out_path = Path(out_path)
                out_path.parent.mkdir(parents=True, exist_ok=True)
                tmp_path = out_path.with_name(out_path.name + ".tmp")
                f = stack.enter_context(tmp_path.open("w", newline=""))
                writer = csv.writer(f)
                writer.writerow(["prediction", "outlier"])
            pipe = run_pipeline(
                source,
                [
                    Stage("encode", encode_chunk),
                    Stage("transfer", transfer_chunk),
                    Stage("compute", compute_chunk),
                    Stage("fetch", fetch_chunks, batch_max=FETCH_WAVE,
                          queue_depth=FETCH_WAVE),
                ],
                write_chunk,
                depth=pipeline_depth,
            )
        if tmp_path is not None:
            tmp_path.replace(out_path)
    except BaseException:
        if tmp_path is not None:
            tmp_path.unlink(missing_ok=True)
        raise
    return {
        "rows": rows,
        "path": scorer.path,
        "mean_prediction": prob_sum / max(rows, 1),
        "outlier_rate": outlier_count / max(rows, 1),
        "pipeline_depth": pipe.depth,
        "elapsed_s": round(pipe.wall_s, 4),
        "rows_per_s": round(rows / max(pipe.wall_s, 1e-9), 1),
        "stages": pipe.stages,
    }
