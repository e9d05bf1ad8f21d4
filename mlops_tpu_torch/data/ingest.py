"""Table ingest: a copy of the JAX package's ``data/ingest.py`` readers
and writer. Columnar lists keyed by the canonical schema, with header
validation; malformed-row semantics as the JAX package pins them: blank
lines skipped, short rows read missing cells as empty (-> OOV / median),
unparseable numerics as NaN (-> median). ``gs://`` paths stage through
``fetch_local``; ``load_table_columns`` routes ``.parquet`` / ``.pq``
files to ``data/parquet.py``."""

from __future__ import annotations

import csv
import hashlib
from pathlib import Path

import numpy as np

from mlops_tpu_torch.schema.features import SCHEMA, FeatureSchema
from mlops_tpu_torch.utils import storage


def fetch_local(path: str | Path, workdir: str | Path | None = None) -> Path:
    """Materialize ``path`` as a local file. Local paths pass through;
    ``gs://`` objects download into ``workdir`` (default: a per-user
    cache under ``~/.cache/mlops_tpu``, shared with the JAX package). The
    cache key holds the path and the object's generation (or md5/size
    when the server omits it), so a dataset staged again at the same URI
    is fetched again instead of served stale."""
    if not storage.is_gcs(path):
        return Path(path)
    workdir = Path(workdir or Path.home() / ".cache" / "mlops_tpu" / "data")
    workdir.mkdir(parents=True, exist_ok=True)
    client = storage.gcs_client()
    meta = client.stat(str(path))
    stamp = str(
        meta.get("generation") or meta.get("md5Hash") or meta.get("size", "")
    )
    tag = hashlib.sha256(f"{path}\x00{stamp}".encode()).hexdigest()[:16]
    local = workdir / f"{tag}-{str(path).rsplit('/', 1)[-1]}"
    if not local.exists():
        client.read_to_file(str(path), local)
    return local


def _cell(row: list, i: int) -> str:
    return row[i] if i < len(row) else ""


def _to_float(raw: str) -> float:
    try:
        return float(raw)
    except ValueError:
        return float("nan")


def rows_to_columns(
    rows: list, col_index: dict[str, int], schema: FeatureSchema = SCHEMA
) -> dict[str, list]:
    """Parsed CSV rows -> columnar lists: categorical cells pass through as
    strings, numerics parse leniently."""
    columns: dict[str, list] = {}
    for feat in schema.categorical:
        i = col_index[feat.name]
        columns[feat.name] = [_cell(row, i) for row in rows]
    for feat in schema.numeric:
        i = col_index[feat.name]
        columns[feat.name] = [_to_float(_cell(row, i)) for row in rows]
    return columns


def parse_labels(
    rows: list, col_index: dict[str, int], schema: FeatureSchema, path, base_row: int
) -> np.ndarray:
    """Strict training-label parse: any unparseable value fails fast."""
    i = col_index[schema.target]
    raw = np.asarray([_to_float(_cell(row, i)) for row in rows])
    bad = ~np.isfinite(raw)
    if bad.any():
        raise ValueError(
            f"{path}: {int(bad.sum())} unparseable value(s) in target "
            f"column {schema.target!r} (first at data row "
            f"{base_row + int(np.argmax(bad))})"
        )
    return raw.astype(np.int8)


def load_csv_columns(
    path: str | Path,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> tuple[dict[str, list], np.ndarray | None]:
    """Read a schema-conforming CSV into columnar lists (+labels if
    present; a target column with any unparseable value reads as
    unlabeled unless ``require_target``)."""
    with fetch_local(path).open(newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row and row != [""]]

    col_index = {name: i for i, name in enumerate(header)}
    missing = [n for n in schema.feature_names if n not in col_index]
    if missing:
        raise ValueError(f"{path}: missing required columns {missing}")
    if require_target and schema.target not in col_index:
        raise ValueError(f"{path}: missing target column {schema.target!r}")

    columns = rows_to_columns(rows, col_index, schema)

    labels = None
    if schema.target in col_index:
        if require_target:
            labels = parse_labels(rows, col_index, schema, path, 0)
        else:
            i = col_index[schema.target]
            raw = np.asarray([_to_float(_cell(row, i)) for row in rows])
            labels = None if (~np.isfinite(raw)).any() else raw.astype(np.int8)
    return columns, labels


def load_table_columns(
    path: str | Path,
    schema: FeatureSchema = SCHEMA,
    require_target: bool = False,
) -> tuple[dict[str, list], np.ndarray | None]:
    """The format-dispatching reader: ``.parquet`` / ``.pq`` routes to
    ``data/parquet.py``, anything else to the CSV reader, one contract
    either way."""
    from mlops_tpu_torch.data import parquet

    if parquet.is_parquet(path):
        return parquet.load_parquet_columns(path, schema, require_target)
    return load_csv_columns(path, schema, require_target)


def write_csv_columns(
    path: str | Path,
    columns: dict[str, list],
    labels: np.ndarray | None = None,
    schema: FeatureSchema = SCHEMA,
) -> None:
    """Write columnar data to CSV in canonical schema order."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(schema.feature_names)
    names_out = names + [schema.target] if labels is not None else names
    n = len(columns[names[0]])
    with path.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(names_out)
        for i in range(n):
            row = [columns[name][i] for name in names]
            if labels is not None:
                row.append(int(labels[i]))
            writer.writerow(row)
