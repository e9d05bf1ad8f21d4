"""The gbm tier and the sklearn floor (gbm, rf) against the JAX package and
scikit-learn, on the CPU.

A small fit, as ``tests/test_gbm_tensor.py`` makes it: 3,000 synthetic
rows, HistGBM with 40 trees of depth 4, rf with 10 trees of depth 4, seed
0, trained by each package's ``run_training``. The JAX package's gbm
programs run under ``jax.enable_x64(True)``, which jax 0.9 has in place of
the ``jax.experimental.enable_x64`` that ``mlops_tpu/ops/gbm_tensor.py``
imports (ROADMAP C-ref 1): a module fixture points that module's and the
JAX engine's ``x64_context`` at it, and nothing in ``mlops_tpu/`` changes.

Tolerances:

- predictions: bitwise, against the JAX programs and engine and against
  ``apply_temperature(predict_proba(X), T)`` (the f64 traversal, the
  serial add chain, one narrowing cast and the f64 tempered branch are
  the same arithmetic), at T = 1 and T != 1, every bucket, padded
  residency and group geometry, unknown ids 200 and 255 included;
- outlier flags, category counts, K-S statistics and the accumulator's
  rows / outliers / batches: exact;
- drift (1 - p) and the accumulator's drift sums: 1e-5 (chi-squared
  p-values through two libraries' ``gammaincc``), 1e-6 more where a
  response's 6-place rounding enters;
- training metrics: 1e-6, and the validation AUC 1e-4 (a few pairs of
  near-equal f32 scores that the two libraries' sigmoids tie or split);
  the fitted estimators and temperatures are equal.
"""

import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mlops_tpu.serve.engine as jax_engine_module
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.data import write_csv_columns as jax_write_csv
from mlops_tpu.data import stream as jstream
from mlops_tpu.data.encode import EncodedDataset as JaxEncodedDataset
from mlops_tpu.monitor import state as jstate
from mlops_tpu.ops import gbm_tensor as jgbm
from mlops_tpu.parallel import bulk as jbulk
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train.pipeline import run_training as jax_run_training
from mlops_tpu_torch.autotune import apply_plan, warm_plan
from mlops_tpu_torch.bundle import load_bundle, save_sklearn_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import Config, ModelConfig, TrainConfig
from mlops_tpu_torch.data import stream
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.monitor.state import init_accumulator
from mlops_tpu_torch.ops import cuda_build
from mlops_tpu_torch.ops import gbm_tensor as tgbm
from mlops_tpu_torch.parallel import bulk
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.tierroute import SLO_ACCURATE, SLO_CHEAP, SLO_DEFAULT
from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS
from mlops_tpu_torch.train.calibrate import apply_temperature
from mlops_tpu_torch.weights import gbm_variables_from_numpy
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROOT = Path(__file__).resolve().parent.parent
DRIFT_ATOL = 1e-5
BUCKETS = (1, 8, 64, 256)
SIZES = {"gbm": dict(n_estimators=40, max_tree_depth=4), "rf": dict(n_estimators=10,
                                                                  max_tree_depth=4)}
sys.path.insert(0, str(ROOT / "scripts"))
import torch_gbm_fixture  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def x64():
    """The JAX gbm programs' double-precision context, as jax 0.9 names it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgbm, "x64_context", lambda: jax.enable_x64(True))
        mp.setattr(jax_engine_module, "x64_context", jgbm.x64_context)
        yield


def _configs(root: Path, family: str, package: str):
    if package == "jax":
        config = JaxConfig()
        config.model = JaxModelConfig(family=family, **SIZES[family])
        config.train = JaxTrainConfig(seed=0)
    else:
        config = Config()
        config.model = ModelConfig(family=family, **SIZES[family])
        config.train = TrainConfig(seed=0, device="cpu")
    config.data.rows = 3000
    config.registry.root = str(root / package / family / "registry")
    config.registry.run_root = str(root / package / family / "runs")
    return config


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package's ``run_training`` of gbm and rf: the results by
    (package, family)."""
    root = tmp_path_factory.mktemp("gbm")
    out = {}
    for family in ("gbm", "rf"):
        out["port", family] = _port_run(root, family)
        out["jax", family] = jax_run_training(_configs(root, family, "jax"))
    return out


def _port_run(root, family):
    from mlops_tpu_torch.train.pipeline import run_training

    return run_training(_configs(root, family, "port"))


@pytest.fixture(scope="module")
def dirs(trained):
    return {key: result.bundle_dir for key, result in trained.items()}


@pytest.fixture(scope="module")
def gbm_bundles(dirs):
    """The port-trained gbm bundle as each package loads it."""
    return jax_load_bundle(dirs["port", "gbm"]), load_bundle(dirs["port", "gbm"])


@pytest.fixture(scope="module")
def batch():
    """64 rows with unknown-category pokes (ids past the vocabulary: the
    table's clamp must agree with sklearn's unknown-category rule)."""
    rng = np.random.default_rng(7)
    cat = rng.integers(0, 4, size=(64, SCHEMA.num_categorical)).astype(np.int32)
    num = rng.normal(size=(64, SCHEMA.num_numeric)).astype(np.float32)
    cat[3, 0] = 200
    cat[9, 2] = 255
    return cat, num


def _reference(bundle, cat, num, temperature=None):
    t = bundle.temperature if temperature is None else temperature
    return apply_temperature(bundle.estimator.predict_proba(cat, num), t).astype(np.float32)


def _bucket(n):
    return next(b for b in BUCKETS if b >= n)


# ---------------------------------------------------------------- trees
def test_extract_gbm_matches_jax_array_for_array(gbm_bundles, dirs):
    jb, tb = gbm_bundles
    want, want_geo = jgbm.extract_gbm(jb.estimator)
    got, got_geo = tgbm.extract_gbm(tb.estimator)
    assert dataclasses.asdict(got_geo) == dataclasses.asdict(want_geo)
    assert set(got) == set(want) == set(tgbm.GBM_FIELDS)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The bundle's tree file holds the same arrays.
    stored, geo = tb.gbm_tensor
    assert geo == got_geo
    for k in want:
        np.testing.assert_array_equal(stored[k], want[k], err_msg=k)
    rf = load_bundle(dirs["port", "rf"])
    assert tgbm.supports_gbm_tensorization(tb.estimator)
    assert not tgbm.supports_gbm_tensorization(rf.estimator)
    assert jgbm.supports_gbm_tensorization(rf.estimator) is False
    assert rf.gbm_tensor is None


@pytest.mark.parametrize("inputs", ["batch", "nan", "synthetic"])
def test_raw_scores_match_jax_and_sklearn(gbm_bundles, batch, inputs):
    """The traversal's f64 scores bitwise against the JAX ``gbm_raw_scores``
    and its f32 probabilities against ``predict_proba``: with unknown ids,
    with NaN numerics (the missing side), and on encoded synthetic rows."""
    jb, tb = gbm_bundles
    cat, num = batch
    if inputs == "nan":
        num = num.copy()
        num[::3, ::4] = np.nan
    elif inputs == "synthetic":
        columns, _ = jax_synthetic(300, seed=11)
        ds = tb.preprocessor.encode(columns)
        cat, num = ds.cat_ids, ds.numeric
    variables, geometry = jgbm.extract_gbm(jb.estimator)
    with jax.enable_x64(True):
        want = np.asarray(jgbm.gbm_raw_scores(
            jax.device_put(variables), geometry.depth, jax.numpy.asarray(cat),
            jax.numpy.asarray(num)))
    tv = gbm_variables_from_numpy(variables, "cpu")
    got = tgbm.gbm_raw_scores(tv, geometry.depth, torch.from_numpy(cat), torch.from_numpy(num))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    proba = tgbm.gbm_reference_proba(tv, geometry, cat, num)
    np.testing.assert_array_equal(proba, tb.estimator.predict_proba(cat, num))


def _jax_state(jb, temperature):
    variables, geometry = jgbm.extract_gbm(jb.estimator)
    with jax.enable_x64(True):
        return (jax.device_put(variables), jax.device_put(np.float64(temperature)),
                geometry)


def _port_state(tb, temperature):
    variables, geometry = tb.gbm_tensor
    return (gbm_variables_from_numpy(variables, "cpu"),
            torch.tensor(temperature, dtype=torch.float64), geometry)


def _temperature(bundle, which):
    return bundle.temperature if which == "bundle" else which


def _assert_packed(got_packed, got_acc, want_packed, want_acc, rows):
    """preds exact, flags exact, drift 1e-5; the accumulator's counts
    exact, drift sums 1e-5 (``rows`` per packed row vector)."""
    got_packed, want_packed = np.asarray(got_packed), np.asarray(want_packed)
    d = SCHEMA.num_categorical + SCHEMA.num_numeric
    assert got_packed.shape == want_packed.shape
    np.testing.assert_array_equal(got_packed[..., : 2 * rows], want_packed[..., : 2 * rows])
    np.testing.assert_allclose(got_packed[..., 2 * rows: 2 * rows + d],
                               want_packed[..., 2 * rows:], rtol=0, atol=DRIFT_ATOL)
    for field in ("rows", "outliers", "batches"):
        assert float(getattr(got_acc, field)) == float(getattr(want_acc, field)), field
    for field in ("drift_sum", "drift_last"):
        np.testing.assert_allclose(np.asarray(getattr(got_acc, field)),
                                   np.asarray(getattr(want_acc, field)), rtol=0,
                                   atol=DRIFT_ATOL, err_msg=field)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 40, 64, 200])
@pytest.mark.parametrize("which", [1.0, "bundle", 1.3], ids=["T1", "Tfit", "T1.3"])
def test_packed_program_matches_jax_every_bucket(gbm_bundles, batch, n, which):
    """``make_gbm_packed_base`` against the jitted JAX program at the
    bucket of ``n`` rows, padded and masked, and against sklearn."""
    jb, tb = gbm_bundles
    temperature = _temperature(tb, which)
    rows = _bucket(n)
    rng = np.random.default_rng(n)
    cat = np.zeros((rows, SCHEMA.num_categorical), np.int32)
    num = np.zeros((rows, SCHEMA.num_numeric), np.float32)
    src_cat, src_num = batch
    take = rng.choice(64, size=n, replace=n > 64)
    cat[:n], num[:n] = src_cat[take], src_num[take]
    mask = np.arange(rows) < n
    jv, jt, geometry = _jax_state(jb, temperature)
    with jax.enable_x64(True):
        want, want_acc = jax.jit(jgbm.make_gbm_packed_base(geometry.depth))(
            jv, jb.monitor, jstate.init_accumulator(), jt, cat, num, mask)
    tv, tt, _ = _port_state(tb, temperature)
    with torch.inference_mode():
        got, got_acc = tgbm.make_gbm_packed_base(geometry.depth)(
            tv, tb.monitor, init_accumulator("cpu"), tt, *map(torch.from_numpy, (cat, num, mask)))
    assert got.dtype == torch.float32
    _assert_packed(got.numpy(), got_acc, want, want_acc, rows)
    np.testing.assert_array_equal(got.numpy()[:n],
                                  _reference(tb, cat[:n], num[:n], temperature))


@pytest.mark.parametrize("slots,rows", [(s, r) for r in GROUP_ROW_BUCKETS
                                        for s in GROUP_SLOT_BUCKETS])
@pytest.mark.parametrize("which", [1.0, "bundle"], ids=["T1", "Tfit"])
def test_grouped_program_matches_jax_every_group_geometry(gbm_bundles, batch, slots, rows,
                                                          which):
    """``make_gbm_grouped_base`` against the jitted JAX vmapped program at
    every group geometry, with ragged and empty slots."""
    jb, tb = gbm_bundles
    temperature = _temperature(tb, which)
    rng = np.random.default_rng(slots * 10 + rows)
    src_cat, src_num = batch
    cat = np.zeros((slots, rows, SCHEMA.num_categorical), np.int32)
    num = np.zeros((slots, rows, SCHEMA.num_numeric), np.float32)
    sizes = rng.integers(0, rows + 1, size=slots)
    sizes[0] = rows
    mask = np.arange(rows)[None, :] < sizes[:, None]
    take = rng.choice(64, size=(slots, rows))
    cat[mask] = src_cat[take][mask]
    num[mask] = src_num[take][mask]
    jv, jt, geometry = _jax_state(jb, temperature)
    with jax.enable_x64(True):
        want, want_acc = jax.jit(jgbm.make_gbm_grouped_base(geometry.depth))(
            jv, jb.monitor, jstate.init_accumulator(), jt, cat, num, mask)
    tv, tt, _ = _port_state(tb, temperature)
    with torch.inference_mode():
        got, got_acc = tgbm.make_gbm_grouped_base(geometry.depth)(
            tv, tb.monitor, init_accumulator("cpu"), tt, *map(torch.from_numpy, (cat, num, mask)))
    _assert_packed(got.numpy(), got_acc, want, want_acc, rows)
    np.testing.assert_array_equal(
        got.numpy()[:, :rows][mask],
        _reference(tb, cat[mask], num[mask], temperature))


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines(gbm_bundles):
    jb, tb = gbm_bundles
    jax_engine = JaxEngine(jb, buckets=(1, 8, 64))
    jax_engine.warmup()
    port = InferenceEngine(tb, buckets=(1, 8, 64), device="cpu")
    port.warmup()
    return jax_engine, port


def _jax_solo(engine, cat, num):
    handle = engine.dispatch_arrays(cat, num)
    handle.start_copy()
    return engine.fetch_arrays_raw(handle)


def _assert_raw(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=DRIFT_ATOL + 1e-6)


def test_engine_matches_the_jax_engine_every_bucket(engines, gbm_bundles, batch):
    """Exact bucket hits and every padded residency class, against the JAX
    engine's packed gbm programs and the sklearn floor."""
    jax_engine, port = engines
    _, tb = gbm_bundles
    cat, num = batch
    ref = _reference(tb, cat, num)
    for n in (1, 2, 5, 8, 9, 40, 64):
        got = port.fetch_arrays_raw(port.dispatch_arrays(cat[:n], num[:n]))
        _assert_raw(got, _jax_solo(jax_engine, cat[:n], num[:n]))
        assert (got[0].astype(np.float32) == ref[:n]).all(), n


def test_engine_matches_the_jax_engine_every_group_geometry(engines, gbm_bundles, batch):
    jax_engine, port = engines
    _, tb = gbm_bundles
    cat, num = batch
    ref = _reference(tb, cat, num)
    for sizes in ([8, 8], [1, 4, 8], [2, 2, 2, 2, 2], [1] * 9, [8] * 64, [1, 1]):
        parts, offset = [], 0
        for n in sizes:
            idx = np.arange(offset, offset + n) % 64
            parts.append((cat[idx], num[idx]))
            offset += n
        got = port.fetch_group_raw(port.dispatch_group_arrays(parts))
        want = jax_engine.fetch_group_raw(jax_engine.dispatch_group_arrays(parts))
        assert list(got[0]) == list(want[0]) == sizes
        for i, n in enumerate(sizes):
            np.testing.assert_array_equal(got[1][i, :n], want[1][i, :n])
            np.testing.assert_array_equal(got[2][i, :n], want[2][i, :n])
            np.testing.assert_allclose(got[3][i], want[3][i], rtol=0, atol=DRIFT_ATOL + 1e-6)
        flat = np.concatenate([np.arange(o, o + n) % 64 for o, n in
                               zip(np.cumsum([0, *sizes[:-1]]), sizes)])
        np.testing.assert_array_equal(
            np.concatenate([got[1][i, :n] for i, n in enumerate(sizes)]).astype(np.float32),
            ref[flat])


def test_monitor_aggregate_matches_the_jax_engine(gbm_bundles, batch):
    jb, tb = gbm_bundles
    cat, num = batch
    jax_engine = JaxEngine(jb, buckets=(1, 8, 64))
    port = InferenceEngine(tb, buckets=(1, 8, 64), device="cpu")
    for engine in (jax_engine, port):
        engine.warmup()
    for n in (3, 64, 1):
        port.fetch_arrays_raw(port.dispatch_arrays(cat[:n], num[:n]))
        _jax_solo(jax_engine, cat[:n], num[:n])
    parts = [(cat[:2], num[:2]), (cat[2:9], num[2:9])]
    port.fetch_group_raw(port.dispatch_group_arrays(parts))
    jax_engine.fetch_group_raw(jax_engine.dispatch_group_arrays(parts))
    got, want = port.monitor_snapshot(), jax_engine.monitor_snapshot()
    for k in ("rows", "outliers", "batches"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["drift_sum"], want["drift_sum"], rtol=0, atol=DRIFT_ATOL)


def test_predict_records_matches_sklearn_floor(engines, gbm_bundles):
    from mlops_tpu_torch.schema.validate import records_to_columns

    jax_engine, port = engines
    _, tb = gbm_bundles
    records = [
        {"age": 30.0, "credit_limit": 2000.0},
        {"age": 55.0, "credit_limit": 90000.0, "education": "graduate"},
    ]
    response = port.predict_records(records)
    ds = tb.preprocessor.encode(records_to_columns(records))
    assert (np.asarray(response["predictions"], np.float32)
            == _reference(tb, ds.cat_ids, ds.numeric)).all()
    want = jax_engine.predict_records(records)
    assert response["predictions"] == want["predictions"]
    assert response["outliers"] == want["outliers"]


@pytest.mark.parametrize("routing", [False, True])
def test_gbm_is_a_single_tier_grouping_family(gbm_bundles, routing):
    """The tree program serves through the packed contract: it groups,
    names its own tier, and (one tier) collapses every SLO class onto it,
    with tier routing asked for too; its tree tensors and temperature are
    f64."""
    _, tb = gbm_bundles
    engine = InferenceEngine(tb, buckets=(1, 8), device="cpu", tier_routing=routing)
    assert engine.supports_grouping and engine.monitor_accumulating
    assert engine.default_tier == "gbm" and engine.available_tiers == ("gbm",)
    assert engine.gbm_geometry == tb.gbm_tensor[1]
    for cls in (SLO_CHEAP, SLO_DEFAULT, SLO_ACCURATE):
        assert engine.route_tier(cls) is None
    tier = engine._tiers["gbm"]
    assert tier.temperature.dtype == torch.float64
    assert tier.params["value"].dtype == tier.params["threshold"].dtype == torch.float64
    engine.warmup()
    assert engine.warmup_stats["programs"] == 2 + 12
    assert engine.warmup_stats["tier"] == "gbm"


def test_the_quant_tier_is_refused_as_the_jax_engine_refuses_it(gbm_bundles, caplog):
    jb, tb = gbm_bundles
    with pytest.raises(ValueError) as port_err:
        InferenceEngine(tb, serve_tier="quant", device="cpu")
    with pytest.raises(ValueError) as jax_err:
        JaxEngine(jb, serve_tier="quant")
    assert str(port_err.value) == str(jax_err.value)
    assert InferenceEngine(tb, serve_tier="auto", device="cpu").default_tier == "gbm"


# ------------------------------------------------------------ tree file
def test_the_tree_file_round_trips_and_refuses_another_format(gbm_bundles, tmp_path):
    jb, _ = gbm_bundles
    variables, geometry = jgbm.extract_gbm(jb.estimator)
    path = tgbm.save_gbm_tensor(tmp_path / "trees.npz", variables, geometry)
    got, got_geo = tgbm.load_gbm_tensor(path)
    assert got_geo == tgbm.GbmGeometry(**dataclasses.asdict(geometry))
    for k in variables:
        assert got[k].dtype == np.asarray(variables[k]).dtype, k
        np.testing.assert_array_equal(got[k], variables[k], err_msg=k)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["format"] = np.array("gbm-gather-v0")
    np.savez(tmp_path / "old.npz", **arrays)
    with pytest.raises(ValueError, match="gbm-gather-v0"):
        tgbm.load_gbm_tensor(tmp_path / "old.npz")


def test_the_tree_carrier_sets_the_device_dtypes(gbm_bundles):
    _, tb = gbm_bundles
    tensors = gbm_variables_from_numpy(tb.gbm_tensor[0], "cpu")
    assert {k: v.dtype for k, v in tensors.items()} == tgbm.GBM_FIELDS
    assert tensors["baseline"].shape == ()
    with pytest.raises(KeyError, match="gbm trees must hold"):
        gbm_variables_from_numpy({"value": tb.gbm_tensor[0]["value"]}, "cpu")


def test_the_bundles_carry_the_tree_file_for_gbm_only(dirs):
    for package in ("port", "jax"):
        assert (dirs[package, "gbm"] / "estimator.joblib").exists()
        assert not (dirs[package, "rf"] / "gbm_tensor.npz").exists()
    assert (dirs["port", "gbm"] / "gbm_tensor.npz").exists()
    assert not (dirs["jax", "gbm"] / "gbm_tensor.npz").exists()
    manifest = json.loads((dirs["port", "gbm"] / "manifest.json").read_text())
    jax_manifest = json.loads((dirs["jax", "gbm"] / "manifest.json").read_text())
    assert set(manifest) == set(jax_manifest)
    assert manifest["flavor"] == jax_manifest["flavor"] == "sklearn"
    assert manifest["model_config"] == jax_manifest["model_config"]
    assert {"scikit-learn", "joblib"} <= set(manifest["framework"])


# ---------------------------------------------------------------- rf
@pytest.fixture(scope="module")
def rf_engines(dirs):
    jax_engine = JaxEngine(jax_load_bundle(dirs["port", "rf"]), buckets=(1, 8, 64))
    port = InferenceEngine(load_bundle(dirs["port", "rf"]), buckets=(1, 8, 64), device="cpu")
    for engine in (jax_engine, port):
        engine.warmup()
    return jax_engine, port


def test_the_rf_hybrid_matches_the_jax_hybrid(rf_engines, batch):
    jax_engine, port = rf_engines
    cat, num = batch
    cat = np.minimum(cat, 3)  # the monitors' vocabulary (the JAX hybrid's jit sees ids)
    assert not port.supports_grouping and not port.monitor_accumulating
    assert port.available_tiers == jax_engine.available_tiers == ("exact",)
    assert port.warmup_stats["programs"] == jax_engine.warmup_stats["programs"] == 3
    for n in (1, 2, 8, 9, 40, 64):
        got = port.fetch_arrays_raw(port.dispatch_arrays(cat[:n], num[:n]))
        _assert_raw(got, _jax_solo(jax_engine, cat[:n], num[:n]))
        np.testing.assert_array_equal(got[0].astype(np.float32),
                                      _reference(port.bundle, cat[:n], num[:n]))
    assert port.monitor_snapshot() == jax_engine.monitor_snapshot() == {}
    assert port.dispatch_counts() == {"bucket_1": 1, "bucket_8": 2, "bucket_64": 3}


def test_the_rf_hybrid_against_make_hybrid_predict_fn(dirs, batch):
    from mlops_tpu.ops.predict import make_hybrid_predict_fn as jax_hybrid
    from mlops_tpu_torch.ops.predict import make_hybrid_predict_fn

    jb, tb = jax_load_bundle(dirs["port", "rf"]), load_bundle(dirs["port", "rf"])
    cat, num = batch
    cat = np.minimum(cat, 3)
    mask = np.arange(64) < 41
    want = jax_hybrid(jb.estimator, jb.monitor, 1.3)(cat, num, mask)
    got = make_hybrid_predict_fn(tb.estimator, tb.monitor, 1.3)(cat, num, mask)
    np.testing.assert_array_equal(got["predictions"], np.asarray(want["predictions"]))
    np.testing.assert_array_equal(got["outliers"].numpy(), np.asarray(want["outliers"]))
    np.testing.assert_allclose(got["feature_drift_batch"].numpy(),
                               np.asarray(want["feature_drift_batch"]), rtol=0, atol=DRIFT_ATOL)
    assert (got["predictions"][~mask] == 0).all()


def test_hot_swaps_refuse_the_hybrid_with_the_jax_messages(rf_engines, engines):
    jax_rf, rf = rf_engines
    jax_gbm, gbm = engines
    for live, candidate, jlive, jcandidate in ((gbm, rf, jax_gbm, jax_rf),
                                               (rf, gbm, jax_rf, jax_gbm)):
        with pytest.raises(ValueError) as port_err:
            live.swap_bundle(candidate)
        with pytest.raises(ValueError) as jax_err:
            jlive.swap_bundle(jcandidate)
        assert str(port_err.value) == str(jax_err.value)
        assert "host-hybrid flavor (rf) redeploys" in str(port_err.value)
    with pytest.raises(ValueError, match="no retired bundle"):
        rf.rollback()
    with pytest.raises(ValueError, match="host-hybrid"):
        rf.warm_grid((1, 8, 64))
    with pytest.raises(ValueError, match="the sklearn flavor has no AOT exec table"):
        warm_plan(rf, (1, 8, 64))
    with pytest.raises(ValueError, match="no grouped path"):
        rf.dispatch_group_arrays([(np.zeros((1, 9), np.int32), np.zeros((1, 14), np.float32))] * 2)


# ------------------------------------------------------- bundle crossing
@pytest.mark.parametrize("family", ["gbm", "rf"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundles_cross_in_both_directions(dirs, batch, family, writer):
    """A bundle either package wrote is read by the other and served to
    the same answers; a JAX-written gbm bundle's trees are extracted from
    its estimator at load."""
    cat, num = batch
    cat = np.minimum(cat, 3)
    jb, tb = jax_load_bundle(dirs[writer, family]), load_bundle(dirs[writer, family])
    np.testing.assert_array_equal(tb.estimator.predict_proba(cat, num),
                                  jb.estimator.predict_proba(cat, num))
    assert tb.temperature == jb.temperature
    jax_engine = JaxEngine(jb, buckets=(64,))
    port = InferenceEngine(tb, buckets=(64,), device="cpu")
    _assert_raw(port.fetch_arrays_raw(port.dispatch_arrays(cat[:37], num[:37])),
                _jax_solo(jax_engine, cat[:37], num[:37]))
    if family == "gbm":
        assert port.default_tier == jax_engine.default_tier == "gbm"
        want, _ = jgbm.extract_gbm(jb.estimator)
        for k in want:
            np.testing.assert_array_equal(tb.gbm_tensor[0][k], want[k], err_msg=k)


@pytest.mark.parametrize("family", ["gbm", "rf"])
def test_train_matches_the_jax_package(trained, dirs, batch, family):
    """Both packages fit the same estimator (the same data, split and seed),
    the same temperature and the same metrics."""
    port, jax_result = trained["port", family], trained["jax", family]
    cat, num = batch
    np.testing.assert_array_equal(
        load_bundle(dirs["port", family]).estimator.predict_proba(cat, num),
        jax_load_bundle(dirs["jax", family]).estimator.predict_proba(cat, num))
    assert port.train_result.steps == jax_result.train_result.steps == SIZES[family][
        "n_estimators"]
    assert set(port.train_result.metrics) == set(jax_result.train_result.metrics)
    for k, v in jax_result.train_result.metrics.items():
        # The metrics take the sigmoid of the clipped probabilities' logits
        # in f32 in each library: one can merge two near-equal scores into
        # a tie the other keeps apart, which moves the AUC by one pair,
        # 1/(n_pos n_neg) ~ 1.6e-5 here (measured: one pair on rf).
        tol = 1e-4 if k == "validation_roc_auc_score" else 1e-6
        assert abs(port.train_result.metrics[k] - v) <= tol, k
    manifests = [json.loads((dirs[p, family] / "manifest.json").read_text())
                 for p in ("port", "jax")]
    assert manifests[0]["calibration"] == manifests[1]["calibration"]
    assert manifests[0]["tags"].keys() == manifests[1]["tags"].keys()


def test_the_train_cli_prints_the_jax_keys(tmp_path, capsys):
    args = ["train", "model.family=rf", "model.n_estimators=5", "model.max_tree_depth=3",
            "data.rows=1200", f"registry.root={tmp_path / 'r'}"]
    capsys.readouterr()
    assert jax_main([*args, f"registry.run_root={tmp_path / 'jr'}"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main([*args, f"registry.run_root={tmp_path / 'pr'}", "train.device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == 5 and got["packaged_step"] == want["packaged_step"]
    assert got["model_uri"].endswith("/2") and want["model_uri"].endswith("/1")


# ------------------------------------------------------ offline scoring
@pytest.fixture(scope="module")
def scoring_rows(gbm_bundles):
    _, tb = gbm_bundles
    columns, _ = jax_synthetic(1500, seed=5)
    ds = tb.preprocessor.encode(columns)
    return columns, ds


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("family", ["gbm", "rf"])
def test_score_dataset_matches_the_jax_scorer(dirs, scoring_rows, family, depth):
    _, ds = scoring_rows
    jb, tb = jax_load_bundle(dirs["port", family]), load_bundle(dirs["port", family])
    want = jbulk.score_dataset(jb, JaxEncodedDataset(ds.cat_ids, ds.numeric), chunk_rows=512,
                               drift_sample=700, pipeline_depth=depth)
    got = bulk.score_dataset(tb, EncodedDataset(ds.cat_ids, ds.numeric), chunk_rows=512,
                             drift_sample=700, pipeline_depth=depth, device="cpu")
    assert got.path == want.path == "exact" and got.rows == want.rows == 1500
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.outliers, want.outliers)
    for k, v in want.feature_drift.items():
        assert abs(got.feature_drift[k] - v) <= DRIFT_ATOL, k
    np.testing.assert_array_equal(got.predictions, _reference(tb, ds.cat_ids, ds.numeric))


def test_the_score_batch_cli_prints_the_jax_keys(dirs, tmp_path, capsys):
    args = ["score-batch", f"serve.model_directory={dirs['port', 'gbm']}", "data.rows=3000",
            "data.seed=3", "score.chunk_rows=1024"]
    capsys.readouterr()
    assert jax_main(args + [f"score.output_path={tmp_path / 'jax.npz'}"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(args + [f"score.output_path={tmp_path / 'port.npz'}", "serve.device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and got["path"] == want["path"] == "exact"
    assert got["default_rate"] == want["default_rate"]
    assert got["outlier_rate"] == want["outlier_rate"]
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        np.testing.assert_array_equal(p["predictions"], j["predictions"])
        np.testing.assert_array_equal(p["outliers"], j["outliers"])


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("family", ["gbm", "rf"])
def test_the_streamed_csv_matches_the_jax_stream(dirs, scoring_rows, tmp_path, family):
    columns, _ = scoring_rows
    jax_write_csv(tmp_path / "in.csv", columns)
    jb, tb = jax_load_bundle(dirs["port", family]), load_bundle(dirs["port", family])
    want = jstream.score_csv_stream(jb, tmp_path / "in.csv", tmp_path / "jax.csv",
                                    chunk_rows=400, native=False)
    got = stream.score_csv_stream(tb, tmp_path / "in.csv", tmp_path / "port.csv",
                                  chunk_rows=400, device="cpu")
    assert set(got) == set(want)
    assert got["rows"] == want["rows"] == 1500 and got["path"] == want["path"]
    assert got["mean_prediction"] == pytest.approx(want["mean_prediction"], abs=1e-9)
    assert got["outlier_rate"] == want["outlier_rate"]
    assert _read(tmp_path / "port.csv") == _read(tmp_path / "jax.csv")


@pytest.mark.parametrize("family", ["gbm", "rf"])
def test_predict_file_prints_what_jax_prints(dirs, scoring_rows, tmp_path, capsys, family):
    columns, _ = scoring_rows
    small = {k: v[:300] for k, v in columns.items()}
    jax_write_csv(tmp_path / "in.csv", small)
    args = ["predict-file", f"data.train_path={tmp_path / 'in.csv'}",
            f"serve.model_directory={dirs['port', family]}"]
    capsys.readouterr()
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(args + ["serve.device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["predictions"] == want["predictions"]
    assert got["outliers"] == want["outliers"]
    for k, v in want["feature_drift_batch"].items():
        assert abs(got["feature_drift_batch"][k] - v) <= DRIFT_ATOL + 1e-6, k


# ------------------------------------------------------------ turnover
def _with_temperature(src: Path, dst: Path, temperature: float) -> Path:
    shutil.copytree(src, dst)
    manifest = json.loads((dst / "manifest.json").read_text())
    manifest["calibration"]["temperature"] = temperature
    (dst / "manifest.json").write_text(json.dumps(manifest))
    return dst


def test_swap_and_rollback_on_the_gbm_tier_as_jax(dirs, batch, tmp_path):
    """A gbm engine hot-swaps to a candidate gbm bundle (the JAX-trained
    twin at T = 1.3): answers are the candidate's bitwise, a rollback
    restores the incumbent's, and the generations move as the JAX
    engine's do."""
    cat, num = batch
    candidate_dir = _with_temperature(dirs["jax", "gbm"], tmp_path / "cand", 1.3)
    live = InferenceEngine(load_bundle(dirs["port", "gbm"]), buckets=(1, 8, 64), device="cpu")
    jlive = JaxEngine(jax_load_bundle(dirs["port", "gbm"]), buckets=(1, 8, 64))
    cand = InferenceEngine(load_bundle(candidate_dir), buckets=(1, 8, 64), device="cpu")
    jcand = JaxEngine(jax_load_bundle(candidate_dir), buckets=(1, 8, 64))
    for engine in (live, jlive, cand, jcand):
        engine.warmup()
    before = live.fetch_arrays_raw(live.dispatch_arrays(cat[:9], num[:9]))
    assert live.swap_bundle(cand) == jlive.swap_bundle(jcand) == 2
    after = live.fetch_arrays_raw(live.dispatch_arrays(cat[:9], num[:9]))
    _assert_raw(after, _jax_solo(jlive, cat[:9], num[:9]))
    np.testing.assert_array_equal(after[0].astype(np.float32),
                                  _reference(cand.bundle, cat[:9], num[:9]))
    assert not np.array_equal(after[0], before[0])
    assert live._tiers["gbm"].temperature.dtype == torch.float64
    assert live.rollback() == jlive.rollback() == 3
    _assert_raw(live.fetch_arrays_raw(live.dispatch_arrays(cat[:9], num[:9])), before)
    assert live.grid_generation == jlive.grid_generation == 1


def test_the_autotuner_regrids_the_gbm_tier(gbm_bundles, batch):
    _, tb = gbm_bundles
    cat, num = batch
    engine = InferenceEngine(tb, buckets=(1, 8, 64), device="cpu")
    engine.warmup()
    want = engine.fetch_arrays_raw(engine.dispatch_arrays(cat[:3], num[:3]))
    assert apply_plan(engine, (1, 3, 8, 64)) == 2
    assert engine.buckets == [1, 3, 8, 64]
    got = engine.fetch_arrays_raw(engine.dispatch_arrays(cat[:3], num[:3]))
    _assert_raw(got, want)
    assert engine.dispatch_counts()["bucket_3"] == 1


def test_the_warmup_command_lists_the_gbm_entries(dirs, tmp_path, capsys):
    from mlops_tpu_torch.compilecache import gbm_serve_entries

    capsys.readouterr()
    try:
        assert main(["warmup", "--cache-dir", str(tmp_path / "cache"),
                     f"serve.model_directory={dirs['port', 'gbm']}"]) == 0
        # ``warmup`` gives the process its cache directory back on return.
        assert cuda_build.cache_dir() is None
    finally:
        cuda_build.set_cache_dir(None)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["libraries"] == [] and report["nvcc_calls"] == 0
    assert report["gbm_entries"][:4] == [f"serve-predict-gbm-packed/b{b}" for b in BUCKETS]
    assert "serve-predict-gbm-group-packed/g64x8" in report["gbm_entries"]
    assert len(report["gbm_entries"]) == 4 + 12
    assert gbm_serve_entries(load_bundle(dirs["port", "rf"]), BUCKETS) is None


# ------------------------------------------------------------- serving
def _serve(engine, post_bodies):
    """An in-process single-process server over ``engine``: the answers to
    ``post_bodies`` and the /metrics text afterwards."""
    import asyncio
    import http.client
    import threading

    from mlops_tpu_torch.config import ServeConfig
    from mlops_tpu_torch.serve.server import HttpServer

    server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0))
    loop = asyncio.new_event_loop()
    srv = loop.run_until_complete(server.start())
    port = srv.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    async def shutdown():
        server.stop_telemetry()
        srv.close()
        await srv.wait_closed()

    try:
        answers = [request("POST", "/predict", body) for body in post_bodies]
        metrics = request("GET", "/metrics")[1].decode()
    finally:
        asyncio.run_coroutine_threadsafe(shutdown(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
        server.close()
    return answers, metrics


def _bodies(n_bodies, seed):
    columns, _ = jax_synthetic(n_bodies * 3, seed=seed)
    records = [{k: columns[k][i] for k in columns} for i in range(n_bodies * 3)]
    return [records[3 * i: 3 * i + 1 + i % 3] for i in range(n_bodies)]


def _metric(text, name):
    line = next(line for line in text.splitlines() if line.startswith(name))
    return float(line.rsplit(" ", 1)[1])


@pytest.mark.parametrize("family", ["gbm", "rf"])
def test_the_server_answers_as_the_engine_and_folds_the_monitor(dirs, family):
    """``POST /predict`` answers what the engine answers alone; a gbm
    plane folds its monitor totals on the device, the rf plane on the host
    from each response (the JAX server's two routes)."""
    bundle = load_bundle(dirs["port", family])
    engine = InferenceEngine(bundle, buckets=(1, 8, 64), device="cpu")
    engine.warmup()
    bodies = _bodies(12, seed=21)
    answers, metrics = _serve(engine, [json.dumps(b).encode() for b in bodies])
    alone = InferenceEngine(bundle, buckets=(1, 8, 64), device="cpu")
    alone.warmup()
    for (status, body), records in zip(answers, bodies):
        assert status == 200
        want = alone.predict_records(records)
        got = json.loads(body)
        assert got["predictions"] == want["predictions"] and got["outliers"] == want["outliers"]
    rows = sum(len(b) for b in bodies)
    assert _metric(metrics, 'mlops_tpu_rows_scored_total{tenant="default"}') == rows
    fetches = _metric(metrics, "mlops_tpu_monitor_fetches_total")
    assert (fetches >= 1) if family == "gbm" else (fetches == 0)


def test_the_ring_plane_serves_a_gbm_bundle(dirs, tmp_path):
    """``serve`` with two front ends over the ring to one engine process
    (``MLOPS_TPU_SERVE_WORKERS=2``, as the serving image starts it) on the
    CPU: every answer equals the engine's alone, grouped or solo."""
    from torch_ring import Plane, exchange

    bundle = load_bundle(dirs["port", "gbm"])
    alone = InferenceEngine(bundle, buckets=(1, 8, 64), device="cpu")
    plane = Plane(dirs["port", "gbm"], tmp_path / "plane.log",
                  env={"MLOPS_TPU_SERVE_WORKERS": "2"}, timeout=120)
    try:
        bodies = _bodies(16, seed=31)
        for records in bodies:
            status, _, body = exchange(plane.port, "POST", "/predict", records)
            assert status == 200
            got, want = json.loads(body), alone.predict_records(records)
            assert got["predictions"] == want["predictions"], plane.text()[-2000:]
            assert got["outliers"] == want["outliers"]
        assert plane.metric('mlops_tpu_tier_requests_total{tier="gbm"}') >= 0
        assert "tiers=gbm" in plane.text()
    finally:
        assert plane.stop() == 0


# ------------------------------------------------ the card's situation
def test_the_fixture_bundle_serves_with_sklearn_blocked(tmp_path):
    """What the card does, here: scikit-learn and joblib blocked, the
    committed fixture's trees served from a bundle built with numpy and
    torch alone, every recorded probability bitwise, and neither module
    loaded at the end."""
    code = f"""
import json, sys
sys.modules["sklearn"] = None
sys.modules["joblib"] = None
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'scripts')!r}]
import numpy as np
import torch_gbm_fixture as fixture
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.serve.engine import InferenceEngine
bundle = load_bundle(fixture.fixture_bundle({str(tmp_path / 'bundle')!r}))
data = fixture.read_fixture()
engine = InferenceEngine(bundle, device="cpu")
engine.warmup()
bad = 0
for lo in range(0, len(data["probs"]), 256):
    hi = lo + 256
    preds = engine.fetch_arrays_raw(engine.dispatch_arrays(
        data["cat_ids"][lo:hi], data["numeric"][lo:hi]))[0]
    bad += int((preds.astype(np.float32) != data["probs"][lo:hi]).sum())
loaded = [m for m in sys.modules if m.split(".")[0] in ("sklearn", "joblib")
          and sys.modules[m] is not None]
print(json.dumps([bad, len(data["probs"]), bundle.estimator is None, loaded,
                  engine.default_tier]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"), timeout=300)
    assert out.returncode == 0, out.stderr
    bad, rows, no_estimator, loaded, tier = json.loads(out.stdout.strip().splitlines()[-1])
    assert (bad, rows, no_estimator, loaded, tier) == (0, 2048, True, [], "gbm")


def test_without_sklearn_a_bundle_without_the_tree_file_names_it(dirs, tmp_path):
    shutil.copytree(dirs["jax", "gbm"], tmp_path / "b")
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['joblib'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from mlops_tpu_torch.bundle import load_bundle\n"
        f"load_bundle({str(tmp_path / 'b')!r})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "scikit-learn" in out.stderr and "gbm_tensor.npz" in out.stderr


def test_the_fixture_regenerates_bit_for_bit(tmp_path):
    """``scripts/torch_gbm_fixture.py`` run afresh gives the committed
    arrays bit for bit, and the bundle it builds without scikit-learn has
    the training run's preprocessor and monitor."""
    committed = torch_gbm_fixture.read_fixture()
    fresh = torch_gbm_fixture.fixture_arrays(tmp_path / "work")
    assert set(fresh) == set(committed)
    for k, v in committed.items():
        assert fresh[k].dtype == v.dtype, k
        np.testing.assert_array_equal(fresh[k], v, err_msg=k)
    assert (int(committed["n_trees"]), int(committed["max_nodes"]),
            int(committed["depth"])) == (75, 61, 8)
    trained = next((tmp_path / "work" / "runs").glob("*/bundle"))
    built = torch_gbm_fixture.fixture_bundle(tmp_path / "built")
    for name in ("preprocess.npz", "monitor.npz"):
        with np.load(trained / name) as a, np.load(built / name) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
    assert load_bundle(built).temperature == float(committed["temperature"])


def test_save_sklearn_bundle_needs_an_estimator_or_trees(gbm_bundles, tmp_path):
    _, tb = gbm_bundles
    with pytest.raises(ValueError, match="an estimator or gbm tree arrays"):
        save_sklearn_bundle(tmp_path / "x", ModelConfig(family="gbm"), tb.preprocessor,
                            tb.monitor)


def test_a_tenant_fleet_warms_the_sklearn_tenants_as_jax(dirs):
    """A fleet of gbm, rf and another gbm tenant: every engine warmed; the
    rf tenant (a host estimator) names no architecture twin, as the JAX
    registry warms the sklearn flavor on its own; the second gbm tenant
    is the first's twin."""
    from mlops_tpu_torch.tenancy.config import TenancyConfig, TenantSpec
    from mlops_tpu_torch.tenancy.registry import TenantRegistry

    tenancy = TenancyConfig(tenants=(
        TenantSpec("a", str(dirs["port", "gbm"])),
        TenantSpec("b", str(dirs["port", "rf"])),
        TenantSpec("c", str(dirs["jax", "gbm"])),
    ))
    registry = TenantRegistry(tenancy, buckets=(1, 8), device="cpu")
    report = registry.warmup()
    assert registry.ready
    assert [e.default_tier for e in registry.engines] == ["gbm", "exact", "gbm"]
    assert report["b"]["route"] == "host_hybrid" and "arch_twin_of" not in report["b"]
    assert report["c"]["arch_twin_of"] == "a"
    assert report["shared_exec_count"] == 0


def test_unknown_ids_count_in_no_bin_as_jax(gbm_bundles, batch):
    """The category counts under the drift give an id outside the
    vocabulary (200, 255) a row of zeros, as ``jax.nn.one_hot`` does; the
    drift then agrees with the JAX monitor's."""
    from mlops_tpu_torch.monitor.state import drift_scores

    jb, tb = gbm_bundles
    cat, num = batch
    k = tb.monitor.cat_ref_counts.shape[1]
    mask = np.arange(64) < 50
    want_counts = np.asarray(
        (jax.nn.one_hot(cat, k) * mask[:, None, None]).sum(axis=0))
    got_counts = ((torch.from_numpy(cat).long()[..., None] == torch.arange(k)).float()
                  * torch.from_numpy(mask)[:, None, None]).sum(dim=0)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    assert want_counts[0].sum() == 49 and want_counts[2].sum() == 49
    want = np.asarray(jstate.drift_scores(jb.monitor, cat, num, mask))
    got = drift_scores(tb.monitor, *map(torch.from_numpy, (cat, num, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DRIFT_ATOL)
