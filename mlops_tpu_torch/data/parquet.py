"""Parquet ingest, the columnar sibling of the CSV reader: a copy of the
JAX package's ``data/parquet.py``. A ``.parquet`` dataset flows through
the same column contract as ``data/ingest.py``: categorical cells as
strings (null -> "" -> OOV), numerics as floats (null or unparseable ->
NaN -> median imputation), labels strict under ``require_target``, so
training, validation and bulk scoring read either format through the
``load_table_columns`` / ``iter_table_chunks`` dispatchers.

pyarrow is an optional dependency, as in the JAX package: it is imported
when a Parquet file is read, and its absence is reported by name.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from mlops_tpu_torch.data.ingest import _to_float, fetch_local
from mlops_tpu_torch.schema.features import SCHEMA, FeatureSchema

PARQUET_SUFFIXES = (".parquet", ".pq")


def is_parquet(path: str | Path) -> bool:
    """Route on file extension — the only signal available for ``gs://``
    URIs without a remote read."""
    return str(path).lower().endswith(PARQUET_SUFFIXES)


def _pyarrow_parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise RuntimeError(
            "Parquet ingest requires pyarrow (`pip install pyarrow`); "
            "convert the dataset to CSV or install it"
        ) from e
    return pq


def _check_columns(
    names: list[str], path, schema: FeatureSchema, require_target: bool
) -> None:
    # Same error contract as the CSV reader (`ingest.load_csv_columns`).
    present = set(names)
    missing = [n for n in schema.feature_names if n not in present]
    if missing:
        raise ValueError(f"{path}: missing required columns {missing}")
    if require_target and schema.target not in present:
        raise ValueError(f"{path}: missing target column {schema.target!r}")


def _cat_cells(array) -> list[str]:
    """Arrow column -> list[str] with CSV semantics: null -> "" (-> OOV),
    non-string storage stringified the way ``csv.writer`` would have
    (ints stay unpadded, floats keep their repr)."""
    out = []
    for v in array.to_pylist():
        if v is None:
            out.append("")
        elif isinstance(v, str):
            out.append(v)
        else:
            out.append(str(v))
    return out


def _num_cells(array) -> list[float]:
    """Arrow column -> list[float]; null -> NaN; string storage parses
    leniently (unparseable -> NaN), matching ``ingest._to_float``.

    Numeric-typed storage converts through Arrow's vectorized cast (nulls
    become NaN in C, no per-cell boxing — this is the bulk-ingest hot
    path); only string-typed columns fall back to per-cell parsing.
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    typ = array.type
    if pa.types.is_string(typ) or pa.types.is_large_string(typ):
        return [_to_float(v) if v is not None else float("nan")
                for v in array.to_pylist()]
    if pa.types.is_boolean(typ):
        array = array.cast(pa.int8())
    casted = array.cast(pa.float64(), safe=False)
    casted = pc.if_else(pc.is_null(casted), float("nan"), casted)
    return casted.to_numpy(zero_copy_only=False).tolist()


def _columns_from_table(table, schema: FeatureSchema) -> dict[str, list]:
    columns: dict[str, list] = {}
    for feat in schema.categorical:
        columns[feat.name] = _cat_cells(table.column(feat.name))
    for feat in schema.numeric:
        columns[feat.name] = _num_cells(table.column(feat.name))
    return columns


def _label_floats(table, schema: FeatureSchema) -> np.ndarray:
    return np.asarray(_num_cells(table.column(schema.target)), dtype=np.float64)


def _strict_labels(
    raw: np.ndarray, path, schema: FeatureSchema, base_row: int
) -> np.ndarray:
    """Training-label contract: fail fast on any null/unparseable value
    (mirrors ``ingest.parse_labels`` / MLOPS_ERR_BAD_LABEL)."""
    bad = ~np.isfinite(raw)
    if bad.any():
        raise ValueError(
            f"{path}: {int(bad.sum())} unparseable value(s) in target "
            f"column {schema.target!r} (first at data row "
            f"{base_row + int(np.argmax(bad))})"
        )
    return raw.astype(np.int8)


def load_parquet_columns(
    path: str | Path,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> tuple[dict[str, list], np.ndarray | None]:
    """Read a schema-conforming Parquet file into columnar lists (+labels).

    Same signature and semantics as ``ingest.load_csv_columns`` — local
    paths and ``gs://`` URIs (staged through the same generation-keyed
    cache), strict labels only under ``require_target``, permissive
    otherwise (one bad value unlabels the file).
    """
    pq = _pyarrow_parquet()
    f = pq.ParquetFile(fetch_local(path))
    names = [field.name for field in f.schema_arrow]
    _check_columns(names, path, schema, require_target)
    wanted = [n for n in (*schema.feature_names, schema.target) if n in names]
    table = f.read(columns=wanted)
    columns = _columns_from_table(table, schema)

    labels = None
    if schema.target in names:
        raw = _label_floats(table, schema)
        if require_target:
            labels = _strict_labels(raw, path, schema, 0)
        else:
            labels = None if (~np.isfinite(raw)).any() else raw.astype(np.int8)
    return columns, labels


def iter_parquet_chunks(
    path: str | Path,
    chunk_rows: int = 65_536,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> Iterator[tuple[dict[str, list], np.ndarray | None]]:
    """Yield ``(columns, labels)`` chunks of EXACTLY ``chunk_rows`` rows
    (except the tail), re-buffering across Arrow record batches — row-group
    boundaries would otherwise fragment chunk shapes and force the
    downstream compiled scorer to pad every chunk. Contract identical to
    ``stream.iter_csv_chunks``: labels only under ``require_target``
    (strict), memory bounded by one chunk + one record batch.
    """
    pq = _pyarrow_parquet()
    f = pq.ParquetFile(fetch_local(path))
    names = [field.name for field in f.schema_arrow]
    _check_columns(names, path, schema, require_target)
    wanted = [n for n in schema.feature_names]
    if require_target:
        wanted.append(schema.target)

    feature_names = list(schema.feature_names)
    buffers: dict[str, list] = {n: [] for n in feature_names}
    label_buffer: list[float] = []
    emitted = 0

    def emit(n: int):
        nonlocal emitted
        columns = {name: buffers[name][:n] for name in feature_names}
        for name in feature_names:
            del buffers[name][:n]
        labels = None
        if require_target:
            raw = np.asarray(label_buffer[:n], dtype=np.float64)
            del label_buffer[:n]
            labels = _strict_labels(raw, path, schema, emitted)
        emitted += n
        return columns, labels

    import pyarrow as pa

    for batch in f.iter_batches(batch_size=chunk_rows, columns=wanted):
        table = pa.Table.from_batches([batch])
        chunk_cols = _columns_from_table(table, schema)
        for name in feature_names:
            buffers[name].extend(chunk_cols[name])
        if require_target:
            label_buffer.extend(_label_floats(table, schema).tolist())
        while len(buffers[feature_names[0]]) >= chunk_rows:
            yield emit(chunk_rows)
    tail = len(buffers[feature_names[0]])
    if tail:
        yield emit(tail)


def write_parquet_columns(
    path: str | Path,
    columns: dict[str, list],
    labels: np.ndarray | None = None,
    schema: FeatureSchema = SCHEMA,
) -> None:
    """Write columnar data to Parquet in canonical schema order: categorical
    as UTF-8 strings, numeric as float64, labels as int8 — the layout
    ``load_parquet_columns`` round-trips losslessly."""
    pq = _pyarrow_parquet()
    import pyarrow as pa

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, names = [], []
    for feat in schema.categorical:
        arrays.append(pa.array([str(v) for v in columns[feat.name]], pa.string()))
        names.append(feat.name)
    for feat in schema.numeric:
        arrays.append(pa.array(columns[feat.name], pa.float64()))
        names.append(feat.name)
    if labels is not None:
        arrays.append(pa.array(np.asarray(labels, dtype=np.int8), pa.int8()))
        names.append(schema.target)
    pq.write_table(pa.Table.from_arrays(arrays, names=names), path)
