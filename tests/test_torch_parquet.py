"""The port's Parquet ingest (``mlops_tpu_torch/data/parquet.py`` and the
``load_table_columns`` / ``iter_table_chunks`` dispatchers) against the
JAX package's readers on the same files, on the CPU.

Twin files: 6,000 synthetic rows written as CSV and as Parquet. Columns,
labels, chunk shapes across row groups, nulls, strict labels with their
row number and the missing-column errors equal the JAX package's exactly
(the same pyarrow reads, the same parsing). ``tune`` on the Parquet twin
prints what it prints on the CSV, and ``score_csv_stream`` and
``score-batch`` on it write what they write for the CSV, exactly: both
formats encode through the same Python pipeline."""

import json
from pathlib import Path

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from mlops_tpu.data.ingest import load_table_columns as jax_load_table_columns  # noqa: E402
from mlops_tpu.data.parquet import iter_parquet_chunks as jax_iter_parquet_chunks  # noqa: E402
from mlops_tpu.data.parquet import load_parquet_columns as jax_load_parquet_columns  # noqa: E402
from mlops_tpu.data.stream import iter_table_chunks as jax_iter_table_chunks  # noqa: E402
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle  # noqa: E402
from mlops_tpu_torch.cli import main  # noqa: E402
from mlops_tpu_torch.config import ModelConfig  # noqa: E402
from mlops_tpu_torch.data import (  # noqa: E402
    Preprocessor,
    generate_synthetic,
    load_csv_columns,
    load_table_columns,
    write_csv_columns,
)
from mlops_tpu_torch.data.parquet import (  # noqa: E402
    is_parquet,
    iter_parquet_chunks,
    load_parquet_columns,
    write_parquet_columns,
)
from mlops_tpu_torch.data.stream import iter_table_chunks, score_csv_stream  # noqa: E402
from mlops_tpu_torch.models import build_model, init_params  # noqa: E402
from mlops_tpu_torch.monitor.state import fit_monitor  # noqa: E402
from mlops_tpu_torch.schema.features import SCHEMA  # noqa: E402

ROWS = 6_000


@pytest.fixture(scope="module")
def twin_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("parquet")
    columns, labels = generate_synthetic(ROWS, seed=23)
    write_csv_columns(root / "data.csv", columns, labels)
    write_parquet_columns(root / "data.parquet", columns, labels)
    return root / "data.csv", root / "data.parquet"


def _same(got, want):
    """Two ``(columns, labels)`` reads equal exactly (NaN equal to NaN)."""
    assert list(got[0]) == list(want[0])
    for name in got[0]:
        np.testing.assert_array_equal(np.asarray(got[0][name]), np.asarray(want[0][name]))
    if want[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("require_target", [False, True])
def test_columns_and_labels_are_the_jax_readers(twin_files, require_target):
    csv_path, pq_path = twin_files
    got = load_parquet_columns(pq_path, require_target=require_target)
    _same(got, jax_load_parquet_columns(pq_path, require_target=require_target))
    _same(got, load_csv_columns(csv_path, require_target=require_target))


def test_the_dispatchers_route_on_the_extension(twin_files):
    csv_path, pq_path = twin_files
    for path in ("x.parquet", "gs://bucket/x.PQ", "a.pq", "x.csv", "x.parquet.csv"):
        assert is_parquet(path) == path.lower().endswith((".parquet", ".pq"))
    for path in twin_files:
        _same(load_table_columns(path, require_target=True),
              jax_load_table_columns(path, require_target=True))
        got = list(iter_table_chunks(path, chunk_rows=2500, require_target=True))
        want = list(jax_iter_table_chunks(path, chunk_rows=2500, require_target=True))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("chunk_rows,row_group", [(1700, None), (500, 97), (64, 1000)])
def test_chunks_are_exact_across_row_groups(tmp_path, twin_files, chunk_rows, row_group):
    path = twin_files[1]
    if row_group:
        path = tmp_path / "rg.parquet"
        pq.write_table(pq.read_table(twin_files[1]), path, row_group_size=row_group)
    got = list(iter_parquet_chunks(path, chunk_rows=chunk_rows, require_target=True))
    want = list(jax_iter_parquet_chunks(path, chunk_rows=chunk_rows, require_target=True))
    sizes = [len(labels) for _, labels in got]
    assert sizes == [chunk_rows] * (ROWS // chunk_rows) + ([ROWS % chunk_rows] if ROWS % chunk_rows else [])
    assert [len(labels) for _, labels in want] == sizes
    for g, w in zip(got, want):
        _same(g, w)


def _table_with(columns, *, null_cat=None, null_num=None, drop=None, labels=None):
    arrays, names = [], []
    for feat in SCHEMA.categorical:
        vals = [str(v) for v in columns[feat.name]]
        if feat.name == (null_cat or (None,))[0]:
            vals[null_cat[1]] = None
        arrays.append(pa.array(vals, pa.string()))
        names.append(feat.name)
    for feat in SCHEMA.numeric:
        if feat.name == drop:
            continue
        vals = list(columns[feat.name])
        if feat.name == (null_num or (None,))[0]:
            vals[null_num[1]] = None
        arrays.append(pa.array(vals, pa.float64()))
        names.append(feat.name)
    if labels is not None:
        arrays.append(pa.array(labels, pa.int8()))
        names.append(SCHEMA.target)
    return pa.Table.from_arrays(arrays, names=names)


def test_nulls_read_as_the_jax_reader_reads_them(tmp_path):
    columns, _ = generate_synthetic(50, seed=1)
    cat, num = SCHEMA.categorical[0].name, SCHEMA.numeric[0].name
    path = tmp_path / "nulls.parquet"
    pq.write_table(_table_with(columns, null_cat=(cat, 3), null_num=(num, 7)), path)
    got = load_parquet_columns(path)
    _same(got, jax_load_parquet_columns(path))
    assert got[1] is None and got[0][cat][3] == "" and np.isnan(got[0][num][7])


def test_strict_labels_fail_with_the_row_number(tmp_path):
    columns, labels = generate_synthetic(40, seed=2)
    target = [int(v) for v in labels]
    target[17] = None
    path = tmp_path / "bad.parquet"
    pq.write_table(_table_with(columns, labels=target), path)
    with pytest.raises(ValueError) as got:
        load_parquet_columns(path, require_target=True)
    with pytest.raises(ValueError) as want:
        jax_load_parquet_columns(path, require_target=True)
    assert str(got.value) == str(want.value) and "data row 17" in str(got.value)
    with pytest.raises(ValueError) as got:
        list(iter_parquet_chunks(path, chunk_rows=10, require_target=True))
    with pytest.raises(ValueError) as want:
        list(jax_iter_parquet_chunks(path, chunk_rows=10, require_target=True))
    assert str(got.value) == str(want.value) and "data row 17" in str(got.value)
    assert load_parquet_columns(path)[1] is None  # permissive: unlabelled


@pytest.mark.parametrize("require_target", [False, True])
def test_missing_columns_fail_as_in_the_jax_reader(tmp_path, require_target):
    columns, labels = generate_synthetic(10, seed=3)
    path = tmp_path / "short.parquet"
    drop = SCHEMA.numeric[2].name if not require_target else None
    pq.write_table(_table_with(columns, drop=drop), path)
    for ours, theirs in ((load_parquet_columns, jax_load_parquet_columns),
                         (lambda p, **k: list(iter_parquet_chunks(p, **k)),
                          lambda p, **k: list(jax_iter_parquet_chunks(p, **k)))):
        with pytest.raises(ValueError) as got:
            ours(path, require_target=require_target)
        with pytest.raises(ValueError) as want:
            theirs(path, require_target=require_target)
        assert str(got.value) == str(want.value)
        assert "missing" in str(got.value)


TUNE = ["model.hidden_dims=16,16", "model.embed_dim=4", "model.precision=f32",
        "train.batch_size=64", "hpo.trials=2", "hpo.steps=12", "train.device=cpu"]


def test_tune_on_parquet_prints_what_it_prints_on_csv(twin_files, tmp_path, capsys):
    out = {}
    for path in twin_files:
        capsys.readouterr()
        assert main(["tune", *TUNE, f"data.train_path={path}",
                     f"registry.root={tmp_path / path.suffix}",
                     f"registry.run_root={tmp_path / 'runs'}",
                     f"registry.run_name={path.suffix[1:]}"]) == 0
        out[path.suffix] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    csv, parquet = out[".csv"], out[".parquet"]
    assert (parquet["best_trial"], parquet["best_hyperparams"], parquet["metrics"]) == (
        csv["best_trial"], csv["best_hyperparams"], csv["metrics"])
    assert ((Path(parquet["bundle"]) / "params.msgpack").read_bytes()
            == (Path(csv["bundle"]) / "params.msgpack").read_bytes())


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    columns, _ = generate_synthetic(2000, seed=5)
    prep = Preprocessor.fit(columns)
    config = ModelConfig(family="mlp", hidden_dims=(16, 16), embed_dim=4, precision="f32")
    directory = tmp_path_factory.mktemp("bundle") / "bundle"
    save_exact_bundle(directory, config, init_params(build_model(config), 0), prep,
                      fit_monitor(prep.encode(columns), drift_ref_size=256),
                      calibration={"temperature": 1.1})
    return directory


def test_stream_scoring_parquet_writes_what_the_csv_writes(twin_files, bundle_dir, tmp_path):
    bundle = load_bundle(bundle_dir)
    stats = {}
    for path in twin_files:
        out = tmp_path / f"{path.suffix[1:]}.out.csv"
        stats[path.suffix] = score_csv_stream(bundle, path, out, chunk_rows=2048,
                                              device="cpu")
        assert stats[path.suffix]["rows"] == ROWS
    assert (tmp_path / "parquet.out.csv").read_bytes() == (tmp_path / "csv.out.csv").read_bytes()
    for key in ("mean_prediction", "outlier_rate", "path"):
        assert stats[".parquet"][key] == stats[".csv"][key]


def test_score_batch_on_parquet_scores_what_it_scores_on_csv(twin_files, bundle_dir,
                                                             tmp_path, capsys):
    got = {}
    for path in twin_files:
        npz = tmp_path / f"{path.suffix[1:]}.npz"
        capsys.readouterr()
        assert main(["score-batch", f"serve.model_directory={bundle_dir}",
                     f"data.train_path={path}", f"score.output_path={npz}",
                     "score.chunk_rows=2048", "serve.device=cpu"]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got[path.suffix] = (summary, np.load(npz))
    (csv_summary, csv_npz), (pq_summary, pq_npz) = got[".csv"], got[".parquet"]
    np.testing.assert_array_equal(pq_npz["predictions"], csv_npz["predictions"])
    np.testing.assert_array_equal(pq_npz["outliers"], csv_npz["outliers"])
    assert pq_summary["rows"] == csv_summary["rows"] == ROWS
    for key in ("path", "default_rate", "outlier_rate", "feature_drift_batch"):
        assert pq_summary[key] == csv_summary[key], key
