"""The exact tier's transformer families (FT-Transformer, single-record
BERT) against the JAX package's, on the CPU.

Small models (token_dim 16, depth 2, 4 heads; BERT reads 48 tokens, the
FT-Transformer 24), weights from the flax ``init`` plus seeded numpy
noise (so biases, LayerNorm scales, ``cls``, ``num_bias`` and
``pos_embed`` all differ from their init), carried across by
``exact_params_from_numpy``; inputs made by numpy from a seed or by the
JAX package's synthetic data. Tolerances:

- eval logits against ``model.apply``: f32 1e-5 (the same f32 arithmetic
  in another summation order); bf16 four bf16 ulps at the logit's
  magnitude (taken as at least 1), the exact tier's logit tolerance, from
  the eager or the jitted apply, whichever is nearer, row by row. The
  frameworks round bf16 products, LayerNorms, softmaxes and GELUs at
  other places, and so does JAX between its own two evaluations: under
  ``jit`` XLA keeps fused bf16 intermediates in f32, which moves these
  models' logits by more than four ulps from the eager apply's on up to
  16 % of rows (measured over 16 seeds of these configs). The JAX engine
  and trainer run the jitted apply; the port's ``F.gelu`` keeps f32 inside
  as that does. Measured worst over those seeds: 4.0 ulps (FT), 3.5 (BERT);
- JAX-trained bundles served by the engine against the JAX engine:
  predictions bf16 1.6e-2 (four ulps of a logit below 4 times the
  sigmoid's slope, at most 1/4), plus 1e-6 for the responses' 6-place
  rounding;
  drift 1e-5 (chi-squared p-values of two libraries); outlier flags exact
  except rows within 1e-5 x threshold of it; accumulator counts exact.
"""

import jax
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.bundle import save_bundle as jax_save_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.monitor import state as jstate
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train.loop import fit as jax_fit
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.weights import exact_params_from_numpy, load_params
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

FAMILIES = ("ft_transformer", "bert")
PRED_TOL = {"f32": 1e-5, "bf16": 1.6e-2}
DRIFT_ATOL = 1e-5
FLAG_BAND = 1e-5


def _kw(family, precision="bf16"):
    return dict(family=family, token_dim=16, depth=2, heads=4, precision=precision)


def _jax_params(kw, seed=0):
    """The flax init of the config, plus seeded noise on every leaf."""
    model = jax_build_model(JaxModelConfig(**kw))
    params = jax_init_params(model, jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32),
        params,
    )
    return model, params


def _port_model(kw, params):
    model = build_model(ModelConfig(**kw))
    return load_params(model, exact_params_from_numpy(params, "cpu")).eval()


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, n) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    num = rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32)
    return cat, num


def _logit_tol(want, precision):
    if precision == "f32":
        return 1e-5
    return 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("family", FAMILIES)
def test_the_port_builds_flax_param_names_and_shapes(family):
    kw = _kw(family)
    _, params = _jax_params(kw)
    want = {k: v.shape for k, v in _flat(params).items()}
    got = {k: tuple(v.shape) for k, v in build_model(ModelConfig(**kw)).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_eval_logits_match_the_flax_apply(family, precision):
    kw = _kw(family, precision)
    jmodel, params = _jax_params(kw, seed=3)
    model = _port_model(kw, params)
    cat, num = _rows(96, seed=4)
    eager = np.asarray(jmodel.apply({"params": params}, cat, num, train=False))
    jitted = np.asarray(jax.jit(
        lambda p, c, x: jmodel.apply({"params": p}, c, x, train=False)
    )(params, cat, num))
    with torch.inference_mode():
        got = model(torch.from_numpy(cat), torch.from_numpy(num))
    assert got.dtype == torch.float32 and got.shape == (96,)
    got = got.numpy()
    err = np.minimum(
        np.abs(got - eager) / _logit_tol(eager, precision),
        np.abs(got - jitted) / _logit_tol(jitted, precision),
    )
    assert (err <= 1.0).all(), err.max()


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_ignores_the_dropout_generator(family):
    kw = dict(_kw(family, "f32"), dropout=0.5)
    _, params = _jax_params(kw, seed=5)
    model = _port_model(kw, params)
    cat, num = (torch.from_numpy(a) for a in _rows(16, seed=6))
    with torch.no_grad():
        plain = model(cat, num)
        with_gen = model(cat, num, train=False, generator=torch.Generator().manual_seed(0))
        trained = model(cat, num, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(plain, with_gen)
    assert not torch.equal(plain, trained)


# ----------------------------------------------------------------- bundles
@pytest.fixture(scope="module")
def fitted():
    columns, _ = jax_synthetic(3000, seed=0)
    prep = JaxPreprocessor.fit(columns)
    return prep, jstate.fit_monitor(prep.encode(columns))


@pytest.fixture(scope="module")
def jax_bundles(tmp_path_factory, fitted):
    """A bundle per family trained by the JAX package's ``fit`` (4 steps
    from the noisy init, so no parameter sits at its init value) and
    written by its ``save_bundle``, bf16."""
    prep, monitor = fitted
    root = tmp_path_factory.mktemp("transformer_bundles")
    columns, labels = jax_synthetic(600, seed=2)
    ds = prep.encode(columns, labels)
    train, valid = ds.slice(np.arange(500)), ds.slice(np.arange(500, 600))
    out = {}
    for family in FAMILIES:
        kw = _kw(family)
        jmodel, params = _jax_params(kw, seed=7)
        result = jax_fit(jmodel, train, valid, JaxTrainConfig(
            steps=4, eval_every=4, batch_size=32, warmup_steps=1, learning_rate=1e-2,
        ), init_variables={"params": params})
        jax_save_bundle(root / family, JaxModelConfig(**kw), result.params, prep, monitor,
                        calibration={"temperature": 1.3})
        out[family] = root / family
    return out


def _records(n, seed, drift=0.0):
    columns, _ = jax_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def _off_band(monitor, num):
    diff = num.astype(np.float64) - np.asarray(monitor.out_mean, np.float64)
    d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(monitor.out_precision, np.float64), diff)
    thr = float(monitor.out_threshold)
    return np.abs(d2 - thr) > FLAG_BAND * abs(thr)


def _assert_response(got, want, bundle, records):
    np.testing.assert_allclose(
        got["predictions"], want["predictions"], atol=PRED_TOL["bf16"] + 1e-6, rtol=0
    )
    assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    g = np.asarray(list(got["feature_drift_batch"].values()))
    w = np.asarray(list(want["feature_drift_batch"].values()))
    np.testing.assert_allclose(g, w, atol=DRIFT_ATOL + 1e-6, rtol=0)
    ds = bundle.preprocessor.encode(records_to_columns(records))
    off = _off_band(bundle.monitor, ds.numeric)
    np.testing.assert_array_equal(
        np.asarray(got["outliers"])[off], np.asarray(want["outliers"])[off]
    )


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_bundles_serve_on_the_port_engine_like_the_jax_engine(jax_bundles, family):
    path = jax_bundles[family]
    jb = jax_load_bundle(path)
    jax_engine = JaxEngine(jb, buckets=(1, 64))
    engine = InferenceEngine(load_bundle(path), buckets=(1, 64), device="cpu")
    assert engine.serve_tier == "exact"
    for n in (1, 64):
        records = _records(n, seed=n, drift=0.3)
        _assert_response(engine.predict_records(records),
                         jax_engine.predict_records(records), jb, records)
    # One group geometry: 10 requests of 3 rows.
    records = _records(30, seed=3)
    ds = jb.preprocessor.encode(records_to_columns(records))
    parts = [(ds.cat_ids[i:i + 3], ds.numeric[i:i + 3]) for i in range(0, 30, 3)]
    got = engine.fetch_group(engine.dispatch_group_arrays(parts))
    want = jax_engine.fetch_group(jax_engine.dispatch_group_arrays(parts))
    for g, w, i in zip(got, want, range(0, 30, 3)):
        _assert_response(g, w, jb, records[i:i + 3])
    snap, jsnap = engine.monitor_snapshot(), jax_engine.monitor_snapshot()
    for key in ("rows", "outliers", "batches"):
        assert snap[key] == jsnap[key], key


@pytest.mark.parametrize("family", FAMILIES)
def test_port_bundles_load_in_the_jax_package(tmp_path, fitted, family):
    prep, monitor = fitted
    kw = _kw(family, "f32")
    jmodel, params = _jax_params(kw, seed=11)
    model = _port_model(kw, params)
    from mlops_tpu_torch.data import Preprocessor
    from mlops_tpu_torch.weights import monitor_from_numpy

    prep.save(tmp_path / "prep.npz")
    save_exact_bundle(
        tmp_path / "b", ModelConfig(**kw), model, Preprocessor.load(tmp_path / "prep.npz"),
        monitor_from_numpy(monitor.to_arrays(), "cpu"), calibration={"temperature": 1.1},
    )
    jb = jax_load_bundle(tmp_path / "b")
    assert jb.model_config.family == family
    cat, num = _rows(32, seed=12)
    want = np.asarray(jmodel.apply({"params": params}, cat, num, train=False))
    got = np.asarray(jb.model.apply(jb.variables, cat, num, train=False))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
