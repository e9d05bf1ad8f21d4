"""The port's bulk scorer (``mlops_tpu_torch.parallel.bulk``) against the
JAX package's ``score_dataset``, on the CPU.

The bundle is JAX-written (``torch_students``: a 4-member mlp ensemble
with its distilled bulk student and gated quant tier), loaded by both
packages. 10,000 rows at chunk 4,096 (two full chunks and a padded tail)
on the exact, distilled and quant paths at depths 1 and 2. Tolerances:

- predictions: the model's precision (``PRED_TOL``, the exact tier's:
  bf16 1.6e-2 for the exact ensemble and the bulk student, f32 1e-5 for
  the quant student's f32 composite forward);
- outlier flags: equal, except rows within 1e-5 x the threshold of it;
- dataset-level drift (the same 10,000-row sample): 1e-5;
- ``path``, ``rows`` and the summary's keys: equal; the port's depth 1
  and depth 2: bitwise equal.
"""

import json
import shutil

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.data.encode import EncodedDataset as JaxEncodedDataset
from mlops_tpu.parallel import bulk as jbulk
from mlops_tpu_torch.bundle import load_bundle, save_doc_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.models import init_params
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.parallel import bulk
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.long_context import build_doc_model
from torch_students import DRIFT_ATOL, PRED_TOL, assert_flags_match, train_jax_bundle
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROWS = 10_000
CHUNK = 4_096
PATHS = {
    "exact": dict(exact=True),
    "distilled": dict(exact=False),
    "quant": dict(tier="quant"),
}


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return train_jax_bundle(tmp_path_factory.mktemp("bulk"))


@pytest.fixture(scope="module")
def bundles(bundle_dir):
    return jax_load_bundle(bundle_dir), load_bundle(bundle_dir)


@pytest.fixture(scope="module")
def datasets(bundles):
    """The same encoded rows for both packages: synthetic data with a
    drift, encoded by the bundle's preprocessor."""
    jb, tb = bundles
    columns, _ = generate_synthetic(ROWS, seed=11, drift=0.3)
    ds = tb.preprocessor.encode(columns)
    return JaxEncodedDataset(ds.cat_ids, ds.numeric), ds


@pytest.fixture(scope="module")
def jax_results(bundles, datasets):
    jb, _ = bundles
    jds, _ = datasets
    return {
        name: jbulk.score_dataset(jb, jds, chunk_rows=CHUNK, **kw)
        for name, kw in PATHS.items()
    }


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", sorted(PATHS))
def test_score_dataset_matches_the_jax_scorer(bundles, datasets, jax_results, name, depth):
    jb, tb = bundles
    _, ds = datasets
    want = jax_results[name]
    got = bulk.score_dataset(
        tb, ds, chunk_rows=CHUNK, pipeline_depth=depth, device="cpu", **PATHS[name]
    )
    assert got.path == want.path == name
    assert got.rows == want.rows == ROWS
    assert got.predictions.dtype == np.float32 and got.predictions.shape == (ROWS,)
    tol = PRED_TOL["f32"] if name == "quant" else PRED_TOL[tb.model_config.precision]
    np.testing.assert_allclose(got.predictions, want.predictions, rtol=0, atol=tol)
    assert_flags_match(got.outliers, want.outliers, ds.numeric, tb.monitor.to_arrays())
    np.testing.assert_allclose(
        [got.feature_drift[k] for k in SCHEMA.feature_names],
        [want.feature_drift[k] for k in SCHEMA.feature_names],
        rtol=0, atol=DRIFT_ATOL,
    )
    summary, jsummary = got.summary(), want.summary()
    assert set(summary) == set(jsummary)
    assert summary["pipeline"]["items"] == jsummary["pipeline"]["items"] == 3
    assert set(summary["pipeline"]["stages"]) == set(jsummary["pipeline"]["stages"])
    assert set(summary["pipeline"]["stages"]) == {
        "span", "slice", "transfer", "compute", "fetch", "store"}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_depth_one_and_two_are_bitwise_equal(bundles, datasets, name):
    _, tb = bundles
    _, ds = datasets
    one, two = (
        bulk.score_dataset(tb, ds, chunk_rows=CHUNK, pipeline_depth=d, device="cpu",
                           **PATHS[name])
        for d in (1, 2)
    )
    assert np.array_equal(one.predictions, two.predictions)
    assert np.array_equal(one.outliers, two.outliers)
    assert one.feature_drift == two.feature_drift


def test_auto_routing_takes_the_student_on_the_cpu(bundles, datasets):
    jb, tb = bundles
    assert bulk.use_distilled_bulk(tb, device="cpu") is True
    assert bulk.use_distilled_bulk(tb, exact=True, device="cpu") is False
    assert jbulk.use_distilled_bulk(jb) is True
    _, ds = datasets
    assert bulk.score_dataset(tb, ds.slice(np.arange(500)), chunk_rows=512,
                              device="cpu").path == "distilled"
    assert bulk.use_quant_bulk(tb, "auto") is True and bulk.use_quant_bulk(tb) is False


def test_the_empty_dataset(bundles):
    jb, tb = bundles
    empty = np.zeros((0, SCHEMA.num_categorical), np.int32), np.zeros(
        (0, SCHEMA.num_numeric), np.float32)
    got = bulk.score_dataset(tb, EncodedDataset(*empty), exact=False, device="cpu")
    want = jbulk.score_dataset(jb, JaxEncodedDataset(*empty), exact=False)
    assert got.summary() == want.summary()
    assert got.rows == 0 and got.predictions.shape == (0,)


def _edited_copy(src, dst, edit):
    shutil.copytree(src, dst)
    manifest = json.loads((dst / "manifest.json").read_text())
    edit(manifest)
    (dst / "manifest.json").write_text(json.dumps(manifest))
    return dst


def test_a_quant_demand_on_an_ungated_bundle_is_refused(bundle_dir, datasets, tmp_path):
    def fail_gates(m):
        m["quant"]["gates"]["passed"] = False

    ungated = _edited_copy(bundle_dir, tmp_path / "ungated", fail_gates)
    _, ds = datasets
    with pytest.raises(ValueError, match="tier='quant' refused") as port_err:
        bulk.score_dataset(load_bundle(ungated), ds, tier="quant", device="cpu")
    with pytest.raises(ValueError, match="tier='quant' refused") as jax_err:
        jbulk.score_dataset(jax_load_bundle(ungated), JaxEncodedDataset(ds.cat_ids, ds.numeric),
                            tier="quant")
    assert str(port_err.value) == str(jax_err.value)
    assert bulk.use_quant_bulk(load_bundle(ungated), "auto") is False


def test_sklearn_and_doc_bundles_are_refused(bundle_dir, datasets, tmp_path):
    _, ds = datasets

    def sklearn(m):
        m["flavor"] = "sklearn"

    # The sklearn flavor is scored (tests/test_torch_gbm.py); a manifest
    # that says sklearn over a directory with neither its estimator nor
    # its tree file is refused at load, naming the estimator's file.
    with pytest.raises(ValueError, match="estimator.joblib"):
        bulk.score_dataset(load_bundle(_edited_copy(bundle_dir, tmp_path / "sk", sklearn)),
                           ds, device="cpu")
    kw = dict(family="bert", doc_records=3, token_dim=16, heads=2, depth=1, precision="f32")
    columns, _ = generate_synthetic(300, seed=0)
    prep = Preprocessor.fit(columns)
    save_doc_bundle(tmp_path / "doc", ModelConfig(**kw),
                    init_params(build_doc_model(ModelConfig(**kw)), seed=1), prep,
                    fit_monitor(prep.encode(columns)))
    with pytest.raises(ValueError, match="the bulk scorer's per-record contract"):
        bulk.score_dataset(load_bundle(tmp_path / "doc"), ds, device="cpu")
    with pytest.raises(SystemExit, match="per-record contract"):
        main(["score-batch", f"serve.model_directory={tmp_path / 'doc'}",
              "serve.device=cpu"])


def test_score_dataset_needs_the_card_unless_asked_for_the_cpu(bundles, datasets):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    _, tb = bundles
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bulk.score_dataset(tb, datasets[1], exact=True)


def _run(entry, argv, capsys):
    capsys.readouterr()
    assert entry(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_score_batch_cli_prints_the_jax_keys(bundle_dir, tmp_path, capsys):
    args = ["score-batch", f"serve.model_directory={bundle_dir}", "data.rows=5000",
            "data.seed=3", "score.chunk_rows=2048"]
    want = _run(jax_main, args + [f"score.output_path={tmp_path / 'jax.npz'}"], capsys)
    got = _run(main, args + [f"score.output_path={tmp_path / 'port.npz'}",
                             "serve.device=cpu"], capsys)
    assert set(got) == set(want)
    assert got["devices"] == 1 and got["mesh"] == [1]
    assert got["path"] == want["path"] == "distilled" and got["rows"] == want["rows"] == 5000
    for k, v in want["feature_drift_batch"].items():
        assert abs(got["feature_drift_batch"][k] - v) <= DRIFT_ATOL + 1e-6, k
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert set(p.files) == set(j.files) == {"predictions", "outliers"}
        tol = PRED_TOL["bf16"]
        np.testing.assert_allclose(p["predictions"], j["predictions"], rtol=0, atol=tol)
        # The default rate may differ only by rows the tolerance straddles
        # across 0.5; the outlier flags are the same rows.
        near = np.mean(np.abs(j["predictions"] - 0.5) <= tol)
        assert abs(got["default_rate"] - want["default_rate"]) <= near + 1e-6
        assert got["outlier_rate"] == want["outlier_rate"]
    exact = _run(main, args + ["score.exact=true", "serve.device=cpu"], capsys)
    assert exact["path"] == "exact"
