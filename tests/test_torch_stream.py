"""The port's stream scorer (``mlops_tpu_torch.data.stream``) against the
JAX package's ``score_csv_stream(native=False)``, on the CPU.

A 6,000-row synthetic CSV (numpy-seeded, with blank lines and a short
row, which both readers skip or read as missing) streams at chunk 2,048
(two full chunks and a tail) through the JAX-written bundle of
``torch_students`` on the exact and the distilled paths. Tolerances: the
output CSVs' predictions within the model's ``PRED_TOL`` (bf16 1.6e-2),
the outlier flags equal except rows within 1e-5 x the threshold of it;
rows, path and the stats' keys equal. A stage that fails leaves neither
the output nor its ``.tmp``.
"""

import csv
import json

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.data import stream as jstream
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
from mlops_tpu_torch.data import stream
from mlops_tpu_torch.data.ingest import load_csv_columns
from torch_students import PRED_TOL, assert_flags_match, train_jax_bundle
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROWS = 6_000
CHUNK = 2_048


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return train_jax_bundle(tmp_path_factory.mktemp("stream"))


@pytest.fixture(scope="module")
def bundles(bundle_dir):
    return jax_load_bundle(bundle_dir), load_bundle(bundle_dir)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream_csv") / "in.csv"
    columns, labels = generate_synthetic(ROWS, seed=21, drift=0.2)
    write_csv_columns(path, columns, labels)
    lines = path.read_text().splitlines(keepends=True)
    lines.insert(100, "\n")  # a blank line: skipped
    lines[200] = ",".join(lines[200].split(",")[:5]) + "\n"  # a short row
    path.write_text("".join(lines))
    return path


def _read(out):
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["prediction", "outlier"]
    return np.array([[float(a), float(b)] for a, b in rows[1:]])


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "distilled"])
def test_stream_scoring_matches_the_jax_stream(bundles, csv_path, tmp_path, exact, depth):
    jb, tb = bundles
    want = jstream.score_csv_stream(
        jb, csv_path, tmp_path / "jax.csv", chunk_rows=CHUNK, exact=exact,
        pipeline_depth=depth, native=False,
    )
    got = stream.score_csv_stream(
        tb, csv_path, tmp_path / "port.csv", chunk_rows=CHUNK, exact=exact,
        pipeline_depth=depth, device="cpu",
    )
    assert set(got) == set(want)
    assert got["rows"] == want["rows"] == ROWS
    assert got["path"] == want["path"] == ("exact" if exact else "distilled")
    assert got["pipeline_depth"] == want["pipeline_depth"] == depth
    assert set(got["stages"]) == set(want["stages"])
    mine, theirs = _read(tmp_path / "port.csv"), _read(tmp_path / "jax.csv")
    assert mine.shape == theirs.shape == (ROWS, 2)
    tol = PRED_TOL[tb.model_config.precision] + 1e-6  # plus the 6-place rounding
    np.testing.assert_allclose(mine[:, 0], theirs[:, 0], rtol=0, atol=tol)
    columns, _ = load_csv_columns(csv_path)
    ds = tb.preprocessor.encode(columns)
    assert_flags_match(mine[:, 1], theirs[:, 1], ds.numeric, tb.monitor.to_arrays())
    assert not (tmp_path / "port.csv.tmp").exists()


def test_depth_one_and_two_write_the_same_file(bundles, csv_path, tmp_path):
    _, tb = bundles
    for depth in (1, 2):
        stream.score_csv_stream(tb, csv_path, tmp_path / f"d{depth}.csv",
                                chunk_rows=CHUNK, pipeline_depth=depth, device="cpu")
    assert (tmp_path / "d1.csv").read_bytes() == (tmp_path / "d2.csv").read_bytes()


@pytest.mark.parametrize("depth", [1, 2])
def test_a_failed_stage_leaves_no_output(bundles, csv_path, tmp_path, monkeypatch, depth):
    _, tb = bundles
    calls = {"n": 0}
    encode = tb.preprocessor.encode

    def failing(columns, *args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("encode failed")
        return encode(columns, *args)

    monkeypatch.setattr(tb.preprocessor, "encode", failing)
    out = tmp_path / "out.csv"
    with pytest.raises(RuntimeError, match="encode failed"):
        stream.score_csv_stream(tb, csv_path, out, chunk_rows=CHUNK,
                                pipeline_depth=depth, device="cpu")
    assert not out.exists()
    assert not (tmp_path / "out.csv.tmp").exists()


def test_a_parquet_file_streams_as_the_jax_package_streams_it(bundles, csv_path, tmp_path):
    pytest.importorskip("pyarrow")
    from mlops_tpu_torch.data.parquet import write_parquet_columns

    jb, tb = bundles
    pq_path = tmp_path / "rows.parquet"
    write_parquet_columns(pq_path, *load_csv_columns(csv_path))
    jstream.score_csv_stream(jb, pq_path, tmp_path / "jax.csv", chunk_rows=CHUNK)
    got = stream.score_csv_stream(tb, pq_path, tmp_path / "port.csv", chunk_rows=CHUNK,
                                  device="cpu")
    stream.score_csv_stream(tb, csv_path, tmp_path / "port_csv.csv", chunk_rows=CHUNK,
                            device="cpu")
    assert got["rows"] == ROWS
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "port_csv.csv").read_bytes()
    mine, theirs = _read(tmp_path / "port.csv"), _read(tmp_path / "jax.csv")
    tol = PRED_TOL[tb.model_config.precision] + 1e-6  # plus the 6-place rounding
    np.testing.assert_allclose(mine[:, 0], theirs[:, 0], rtol=0, atol=tol)
    ds = tb.preprocessor.encode(load_csv_columns(csv_path)[0])
    assert_flags_match(mine[:, 1], theirs[:, 1], ds.numeric, tb.monitor.to_arrays())


def test_the_streaming_cli_prints_the_jax_keys(bundle_dir, csv_path, tmp_path, capsys):
    args = ["score-batch", "score.streaming=true", f"data.train_path={csv_path}",
            f"serve.model_directory={bundle_dir}", f"score.chunk_rows={CHUNK}"]
    capsys.readouterr()
    assert jax_main(args + [f"score.output_path={tmp_path / 'jax.csv'}"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(args + [f"score.output_path={tmp_path / 'port.csv'}",
                        "serve.device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["rows"] == want["rows"] == ROWS and got["path"] == want["path"]
    assert abs(got["mean_prediction"] - want["mean_prediction"]) <= PRED_TOL["bf16"]
    assert _read(tmp_path / "port.csv").shape == (ROWS, 2)
