"""The port's exact tier against the JAX package's, on the CPU.

Small models (mlp hidden (32, 32, 16), embed 4; linear; the mlp as an
8-member deep ensemble at hidden (16, 8)), weights from the flax ``init``
plus seeded numpy noise (so biases, LayerNorm scales and every member
differ), carried across by ``exact_params_from_numpy``; inputs made by
numpy from a seed or by the JAX package's synthetic data. Tolerances:

- logits against ``model.apply``: f32 2e-5 (the same f32 arithmetic in
  another summation order); bf16 four bf16 ulps at the logit's magnitude
  (taken as at least 1): the frameworks round bf16 products, LayerNorms
  and GELUs at other places, and under ``jit`` XLA keeps fused bf16
  intermediates in f32 (measured: up to 2 ulps against the eager apply,
  3 against the jitted one, which is itself 2 ulps from the eager one);
- K-S statistics, category counts and accumulator rows / outliers /
  batches: exact (integer counts, one correctly rounded f32 division);
- K-S p-values 1e-6 (the same f32 series); chi-squared p-values 1e-5
  (``gammaincc`` of two libraries), so drift (1 - p) is 1e-5 on the
  categorical features and 1e-6 on the numeric ones; drift sums 1e-5;
- predictions: f32 1e-5; bf16 1.6e-2 (four ulps of a logit below 4,
  0.0625, times the sigmoid's slope, at most 1/4; past 4 the slope is
  smaller by more than the ulp grows), and 1e-6 (the responses' 6-place
  rounding) added where a response is compared;
- outlier flags: exact except rows within 1e-5 x threshold of it.
"""

import asyncio
import http.client
import json
import logging
import threading

import jax
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.bundle import save_bundle as jax_save_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.data import write_csv_columns as jax_write_csv
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.monitor import state as jstate
from mlops_tpu.ops import drift as jdrift
from mlops_tpu.ops import predict as jpredict
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig, ServeConfig, load_config
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.monitor import state as tstate
from mlops_tpu_torch.ops import drift as tdrift
from mlops_tpu_torch.ops import predict as tpredict
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.server import HttpServer
from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS
from mlops_tpu_torch.train.long_context import build_doc_model, check_doc_attention
from mlops_tpu_torch.weights import exact_params_from_numpy, load_params, monitor_from_numpy
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

PRED_TOL = {"f32": 1e-5, "bf16": 1.6e-2}
KS_P_ATOL = 1e-6
CHI2_P_ATOL = 1e-5
FLAG_BAND = 1e-5
TEMPERATURE = 1.37

CONFIGS = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4),
    "mlp-ens8": dict(family="mlp", hidden_dims=(16, 8), embed_dim=4, ensemble_size=8),
}


def _config(name, precision="bf16"):
    return dict(CONFIGS[name], precision=precision)


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
        return 2e-5
    return 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_the_flax_apply(name, precision):
    kw = _config(name, precision)
    jmodel, params = _jax_params(kw, seed=3)
    model = _port_model(kw, params)
    cat, num = _rows(96, seed=4)
    want = np.asarray(jmodel.apply({"params": params}, cat, num, train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(cat), torch.from_numpy(num))
    assert got.dtype == torch.float32 and got.shape == (96,)
    assert (np.abs(_np(got) - want) <= _logit_tol(want, precision)).all()


def test_the_ensemble_holds_its_members_on_a_leading_axis():
    kw = _config("mlp-ens8")
    _, params = _jax_params(kw)
    model = _port_model(kw, params)
    state = model.state_dict()
    assert all(k.startswith("member.") for k in state)
    assert all(v.shape[0] == 8 for v in state.values())
    assert state["member.stem.kernel"].shape == (8, 9 * 4 + 14, 16)


@pytest.mark.parametrize(
    "kw,item",
    [
        # The tree families have no module: refused with the JAX message.
        pytest.param(dict(family="rf"), "CPU sklearn baseline", id="kw0-A8"),
        # The moe family and its ensembles are ported: they build, and the
        # flax param tree loads into them name for name, shape for shape.
        pytest.param(dict(family="moe", ensemble_size=2), None, id="kw1-A9"),
        pytest.param(dict(family="moe"), None, id="kw2-A9"),
        pytest.param(dict(family="gbm"), "CPU sklearn baseline", id="kw3-A8"),
    ],
)
def test_build_model_refuses_the_families_it_does_not_port(kw, item):
    if item is None:
        kw = dict(kw, token_dim=16, depth=1, heads=2, num_experts=4)
        _, params = _jax_params(kw)
        model = _port_model(kw, params)  # load_params refuses any mismatch
        leaves = jax.tree_util.tree_leaves(params)
        assert len(model.state_dict()) == len(leaves)
        lead = (kw["ensemble_size"],) if "ensemble_size" in kw else ()
        name = ("member." if lead else "") + "block_0.MoEFeedForward_0.experts_out"
        assert model.state_dict()[name].shape == lead + (4, 64, 16)
        return
    with pytest.raises(ValueError, match=item):
        build_model(ModelConfig(**kw))
    if kw["family"] in ("gbm", "rf"):
        with pytest.raises(ValueError) as jax_err:
            jax_build_model(JaxModelConfig(**kw))
        with pytest.raises(ValueError) as port_err:
            build_model(ModelConfig(**kw))
        assert str(port_err.value) == str(jax_err.value)


def test_a_param_tree_that_does_not_match_is_refused():
    kw = _config("mlp")
    _, params = _jax_params(kw)
    model = build_model(ModelConfig(**dict(kw, embed_dim=8)))
    with pytest.raises(ValueError, match="shapes"):
        load_params(model, exact_params_from_numpy(params, "cpu"))


# --------------------------------------------------------------------- K-S
def _ks_inputs(m, b, seed, r=512):
    """A sorted reference with ties; a batch with exact reference points,
    ties within the batch and values past both ends; a partial mask, with
    the last feature's batch all padding."""
    rng = np.random.default_rng(seed)
    ref = np.sort(np.round(rng.normal(size=(m, r)), 1).astype(np.float32), axis=1)
    batch = rng.normal(size=(m, b)).astype(np.float32)
    pick = rng.integers(0, 4, size=(m, b))
    batch = np.where(pick == 1, ref[np.arange(m)[:, None], rng.integers(0, r, (m, b))], batch)
    batch = np.where(pick == 2, batch[:, :1], batch)
    batch = np.where(pick == 3, 5.0 * np.sign(batch), batch).astype(np.float32)
    mask = rng.random((m, b)) < 0.7
    mask[:, 0] = True
    mask[-1] = False
    cdf = np.stack([np.searchsorted(row, row, side="right") / r for row in ref]).astype(np.float32)
    return ref, cdf, batch, mask


@pytest.mark.parametrize("b", [1, 8, 64, 65, 256])
def test_ks_two_sample_matches_jax(b):
    ref, _, batch, _ = _ks_inputs(4, b, seed=b)
    j_stat, j_p = jax.vmap(jdrift.ks_two_sample)(ref, batch)
    t_stat, t_p = tdrift.ks_two_sample(torch.from_numpy(ref), torch.from_numpy(batch))
    np.testing.assert_array_equal(_np(t_stat), np.asarray(j_stat))
    np.testing.assert_allclose(_np(t_p), np.asarray(j_p), atol=KS_P_ATOL, rtol=0)


@pytest.mark.parametrize("b", [1, 8, 64, 65, 256])
def test_ks_two_sample_small_masked_matches_jax(b):
    ref, cdf, batch, mask = _ks_inputs(4, b, seed=10 + b)
    j_stat, j_p = jax.vmap(jdrift.ks_two_sample_small_masked)(ref, cdf, batch, mask)
    t_stat, t_p = tdrift.ks_two_sample_small_masked(
        *(torch.from_numpy(a) for a in (ref, cdf, batch, mask))
    )
    np.testing.assert_array_equal(_np(t_stat), np.asarray(j_stat))
    assert _np(t_stat)[-1] == 0.0  # all padding: no signal
    np.testing.assert_allclose(_np(t_p), np.asarray(j_p), atol=KS_P_ATOL, rtol=0)


@pytest.mark.parametrize("b", [1, 8, 64, 65, 256])
def test_ks_two_sample_masked_matches_jax(b):
    ref, _, batch, mask = _ks_inputs(4, b, seed=20 + b)
    j_stat, j_p = jax.vmap(jdrift.ks_two_sample_masked)(ref, batch, mask)
    t_stat, t_p = tdrift.ks_two_sample_masked(
        *(torch.from_numpy(a) for a in (ref, batch, mask))
    )
    np.testing.assert_array_equal(_np(t_stat), np.asarray(j_stat))
    assert _np(t_stat)[-1] == 0.0
    np.testing.assert_allclose(_np(t_p), np.asarray(j_p), atol=KS_P_ATOL, rtol=0)


# ------------------------------------------------------------------ monitor
@pytest.fixture(scope="module")
def fitted():
    columns, _ = jax_synthetic(3000, seed=0)
    prep = JaxPreprocessor.fit(columns)
    monitor = jstate.fit_monitor(prep.encode(columns))
    held, _ = jax_synthetic(2048, seed=1, drift=0.4)
    return prep, monitor, monitor_from_numpy(monitor.to_arrays(), "cpu"), prep.encode(held)


def _batch(ds, s, b, seed, mask_kind="partial"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ds.n, size=s * b)
    cat = ds.cat_ids[idx].reshape(s, b, -1)
    num = ds.numeric[idx].reshape(s, b, -1).astype(np.float32)
    mask = np.ones((s, b), bool)
    if mask_kind == "partial":
        for i in range(s):
            mask[i, int(rng.integers(1, b + 1)):] = False
        if s > 1:
            mask[-1] = False  # an all-padding slot
    elif mask_kind == "none":
        mask[:] = False
    return cat, num, mask


def _assert_drift(got, want):
    c = SCHEMA.num_categorical
    got, want = _np(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[..., :c][ok[..., :c]], want[..., :c][ok[..., :c]],
                               atol=CHI2_P_ATOL, rtol=0)
    np.testing.assert_allclose(got[..., c:][ok[..., c:]], want[..., c:][ok[..., c:]],
                               atol=KS_P_ATOL, rtol=0)


@pytest.mark.parametrize("masked", ["mask", "no mask"])
@pytest.mark.parametrize("b", [1, 8, 64, 65, 256])
def test_drift_scores_match_jax(fitted, b, masked):
    _, jmon, tmon, ds = fitted
    cat, num, mask = _batch(ds, 1, b, seed=b)
    cat, num, mask = cat[0], num[0], mask[0]
    jm = mask if masked == "mask" else None
    want = jstate.drift_scores(jmon, cat, num, jm)
    got = tstate.drift_scores(
        tmon, torch.from_numpy(cat), torch.from_numpy(num),
        None if jm is None else torch.from_numpy(mask),
    )
    _assert_drift(got, want)


@pytest.mark.parametrize("b", [1, 8, 64, 65, 256])
def test_drift_scores_of_an_all_padding_batch_match_jax(fitted, b):
    _, jmon, tmon, ds = fitted
    cat, num, mask = (a[0] for a in _batch(ds, 1, b, seed=b, mask_kind="none"))
    want = jstate.drift_scores(jmon, cat, num, mask)
    got = tstate.drift_scores(tmon, *(torch.from_numpy(a) for a in (cat, num, mask)))
    _assert_drift(got, want)


def test_drift_scores_over_slots_match_a_jax_vmap(fitted):
    _, jmon, tmon, ds = fitted
    cat, num, mask = _batch(ds, 5, 8, seed=3)
    want = jax.vmap(jstate.drift_scores, in_axes=(None, 0, 0, 0))(jmon, cat, num, mask)
    got = tstate.drift_scores(tmon, *(torch.from_numpy(a) for a in (cat, num, mask)))
    _assert_drift(got, want)


def test_outlier_flags_match_jax(fitted):
    _, jmon, tmon, ds = fitted
    cat, num, mask = (a[0] for a in _batch(ds, 1, 256, seed=5))
    want = np.asarray(jstate.outlier_flags(jmon, num, mask))
    got = _np(tstate.outlier_flags(tmon, torch.from_numpy(num), torch.from_numpy(mask)))
    off = _off_band(jmon, num)
    np.testing.assert_array_equal(got[off], want[off])


def _off_band(jmon, num):
    diff = num.astype(np.float64) - np.asarray(jmon.out_mean, np.float64)
    d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(jmon.out_precision, np.float64), diff)
    thr = float(jmon.out_threshold)
    return np.abs(d2 - thr) > FLAG_BAND * abs(thr)


def _acc(rng, batches):
    d = SCHEMA.num_categorical + SCHEMA.num_numeric
    return dict(
        rows=np.float32(rng.integers(0, 500)), outliers=np.float32(rng.integers(0, 50)),
        batches=np.float32(batches), drift_sum=rng.random(d).astype(np.float32),
        drift_last=rng.random(d).astype(np.float32),
    )


@pytest.mark.parametrize("newer_batches", [0, 3])
def test_merge_accumulators_matches_jax(newer_batches):
    rng = np.random.default_rng(newer_batches)
    older, newer = _acc(rng, 5), _acc(rng, newer_batches)
    want = jstate.merge_accumulators(
        jstate.MonitorAccumulator(**older), jstate.MonitorAccumulator(**newer)
    )
    got = tstate.merge_accumulators(
        tstate.MonitorAccumulator(**{k: torch.tensor(v) for k, v in older.items()}),
        tstate.MonitorAccumulator(**{k: torch.tensor(v) for k, v in newer.items()}),
    )
    for field in ("rows", "outliers", "batches", "drift_sum", "drift_last"):
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(want, field)))


# ----------------------------------------------------------- packed programs
def _assert_accumulators(got, want):
    for field in ("rows", "outliers", "batches"):
        assert float(getattr(got, field)) == float(getattr(want, field)), field
    for field in ("drift_sum", "drift_last"):
        np.testing.assert_allclose(
            _np(getattr(got, field)), np.asarray(getattr(want, field)), atol=1e-5, rtol=0
        )


def _assert_packed(got, want, rows, jmon, num, pred_tol):
    p, o, d = tpredict.packed_layout(rows)
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., p], want[..., p], atol=pred_tol, rtol=0)
    off = _off_band(jmon, num.reshape(-1, num.shape[-1])).reshape(got[..., o].shape)
    np.testing.assert_array_equal(got[..., o][off], want[..., o][off])
    _assert_drift(got[..., d], want[..., d])


@pytest.fixture(scope="module")
def packed_models():
    kw = _config("mlp-ens8", "f32")
    jmodel, params = _jax_params(kw, seed=5)
    model = _port_model(kw, params)
    return jmodel, {"params": params}, model


@pytest.mark.parametrize("rows", [1, 8, 64, 256])
def test_packed_predict_matches_jax_at_every_bucket(fitted, packed_models, rows):
    _, jmon, tmon, ds = fitted
    jmodel, variables, model = packed_models
    cat, num, mask = (a[0] for a in _batch(ds, 1, rows, seed=rows))
    t = np.float32(TEMPERATURE)
    want, want_acc = jax.jit(jpredict.make_packed_predict_base(jmodel))(
        variables, jmon, jstate.init_accumulator(), t, cat, num, mask
    )
    with torch.inference_mode():
        got, got_acc = tpredict.make_packed_predict_base(model)(
            tpredict.model_params(model), tmon, tstate.init_accumulator("cpu"),
            torch.tensor(t), *(torch.from_numpy(a) for a in (cat, num, mask)),
        )
    _assert_packed(got, want, rows, jmon, num, PRED_TOL["f32"])
    _assert_accumulators(got_acc, want_acc)


@pytest.mark.parametrize("slots", GROUP_SLOT_BUCKETS)
@pytest.mark.parametrize("rows", GROUP_ROW_BUCKETS)
def test_packed_grouped_matches_jax_at_every_geometry(fitted, packed_models, rows, slots):
    _, jmon, tmon, ds = fitted
    jmodel, variables, model = packed_models
    cat, num, mask = _batch(ds, slots, rows, seed=rows * 100 + slots)
    t = np.float32(TEMPERATURE)
    want, want_acc = jax.jit(jpredict.make_packed_grouped_base(jmodel))(
        variables, jmon, jstate.init_accumulator(), t, cat, num, mask
    )
    with torch.inference_mode():
        got, got_acc = tpredict.make_packed_grouped_base(model)(
            tpredict.model_params(model), tmon, tstate.init_accumulator("cpu"),
            torch.tensor(t), *(torch.from_numpy(a) for a in (cat, num, mask)),
        )
    _assert_packed(got, want, rows, jmon, num, PRED_TOL["f32"])
    _assert_accumulators(got_acc, want_acc)


# -------------------------------------------------------- bundles and tiers
@pytest.fixture(scope="module")
def exact_bundles(tmp_path_factory, fitted):
    """A port-written flax bundle per served model (linear, mlp and
    mlp-ens8 at bf16, seeded weights), with a gated quant tier beside the
    exact one in the mlp's."""
    prep, _, tmon, _ = fitted
    root = tmp_path_factory.mktemp("exact_bundles")
    port_prep = _port_prep(prep, root)
    out = {}
    for name in sorted(CONFIGS):
        kw = _config(name)
        _, params = _jax_params(kw, seed=7)
        model = _port_model(kw, params)
        path = root / name
        quant = {}
        if name == "mlp":
            quant = dict(
                quant_params=quantize_student(init_quant_master(0)),
                quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}},
            )
        save_exact_bundle(
            path, ModelConfig(**kw), model, port_prep, tmon,
            calibration={"temperature": TEMPERATURE}, **quant,
        )
        out[name] = path
    return out


def _port_prep(jax_prep, root):
    """The JAX preprocessor's fitted state, read by the port."""
    from mlops_tpu_torch.data import Preprocessor

    path = root / "preprocess.npz"
    jax_prep.save(path)
    return Preprocessor.load(path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_bundles_load_in_both_packages(exact_bundles, name):
    path = exact_bundles[name]
    jb, tb = jax_load_bundle(path), load_bundle(path)
    assert tb.flavor == jb.flavor == "flax" and tb.model_config.family == CONFIGS[name]["family"]
    jflat = {
        ".".join(k.key for k in key): np.asarray(v)
        for key, v in jax.tree_util.tree_flatten_with_path(jb.variables["params"])[0]
    }
    tflat = {k: v.numpy() for k, v in tb.model.state_dict().items()}
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    assert tb.has_quant == (name == "mlp") == jb.has_quant


def test_jax_bundles_load_in_the_port(tmp_path, fitted):
    prep, jmon, _, _ = fitted
    kw = _config("mlp-ens8", "f32")
    jmodel, params = _jax_params(kw, seed=9)
    jax_save_bundle(tmp_path, JaxModelConfig(**kw), params, prep, jmon,
                    calibration={"temperature": 1.2})
    tb = load_bundle(tmp_path)
    assert tb.temperature == 1.2 and not tb.has_quant
    cat, num = _rows(32, seed=1)
    want = np.asarray(jmodel.apply({"params": params}, cat, num, train=False))
    with torch.inference_mode():
        got = tb.model(torch.from_numpy(cat), torch.from_numpy(num))
    assert (np.abs(_np(got) - want) <= _logit_tol(want, "f32")).all()


class _Shards:
    """A stand-in for a ('model',) mesh of ``n`` ranks: all the tier table
    reads of one."""

    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n


def test_the_tier_table(exact_bundles, tmp_path, caplog):
    mlp = load_bundle(exact_bundles["mlp"])
    ens = load_bundle(exact_bundles["mlp-ens8"])
    assert InferenceEngine(mlp, device="cpu").serve_tier == "exact"
    assert InferenceEngine(mlp, serve_tier="quant", device="cpu").serve_tier == "quant"
    assert InferenceEngine(mlp, serve_tier="auto", device="cpu").serve_tier == "quant"
    with pytest.raises(ValueError, match="no quant params"):
        InferenceEngine(ens, serve_tier="quant", device="cpu")
    with caplog.at_level(logging.INFO, logger="mlops_tpu_torch.serve.engine"):
        assert InferenceEngine(ens, serve_tier="auto", device="cpu").serve_tier == "exact"
    assert "falling back to exact tier: bundle carries no quant params" in caplog.text
    with pytest.raises(ValueError, match="serve_tier must be"):
        InferenceEngine(mlp, serve_tier="int8", device="cpu")
    # serve.model_shards loads; over more than one rank the quant tier is
    # refused with the JAX engine's message (the tier table reads only the
    # mesh's size).
    assert load_config(["serve.model_shards=4"]).serve.model_shards == 4
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_load_bundle(exact_bundles["mlp"]), buckets=(1,), serve_tier="quant",
                  model_shards=4)
    with pytest.raises(ValueError) as got:
        InferenceEngine(mlp, serve_tier="quant", device="cpu", mesh=_Shards(4))
    assert str(got.value) == str(want.value)
    assert "quant tier is single-device; model_shards > 1" in str(got.value)
    # A moe bundle (the family is ported) loads with its exact tier and
    # serves on it, answering as the JAX engine does on the same bundle.
    kw = dict(family="moe", token_dim=16, depth=1, heads=2, num_experts=4,
              precision="bf16")
    _, params = _jax_params(kw, seed=7)
    linear = load_bundle(exact_bundles["linear"])
    save_exact_bundle(tmp_path / "moe", ModelConfig(**kw), _port_model(kw, params),
                      linear.preprocessor, linear.monitor,
                      calibration={"temperature": TEMPERATURE})
    moe = load_bundle(tmp_path / "moe")
    assert moe.model is not None and moe.exact_refusal == ""
    engine = InferenceEngine(moe, buckets=(1, 8), device="cpu")
    assert engine.serve_tier == "exact"
    records = _records(5, seed=5, drift=0.3)
    jb = jax_load_bundle(tmp_path / "moe")
    _assert_response(engine.predict_records(records),
                     JaxEngine(jb, buckets=(1, 8)).predict_records(records),
                     jb, records, PRED_TOL["bf16"] + 1e-6)
    # An sklearn manifest over a directory with neither the estimator nor
    # the tree file: refused at load, naming the files.
    manifest = json.loads((tmp_path / "moe" / "manifest.json").read_text())
    manifest["flavor"] = "sklearn"
    (tmp_path / "moe" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="estimator.joblib"):
        InferenceEngine(load_bundle(tmp_path / "moe"), device="cpu")


def test_the_exact_tier_needs_the_card_unless_asked_for_the_cpu(exact_bundles):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    bundle = load_bundle(exact_bundles["linear"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(bundle)


def _records(n, seed, drift=0.0):
    columns, _ = jax_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def _assert_response(got, want, bundle, records, pred_tol):
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=pred_tol, rtol=0)
    assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    g = np.asarray(list(got["feature_drift_batch"].values()))
    w = np.asarray(list(want["feature_drift_batch"].values()))
    np.testing.assert_allclose(g, w, atol=CHI2_P_ATOL + 1e-6, rtol=0)
    ds = bundle.preprocessor.encode(records_to_columns(records))
    off = _off_band(bundle.monitor, ds.numeric)
    np.testing.assert_array_equal(np.asarray(got["outliers"])[off], np.asarray(want["outliers"])[off])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_jax_engine_on_the_exact_tier(exact_bundles, name):
    path = exact_bundles[name]
    jax_engine = JaxEngine(jax_load_bundle(path), buckets=(1, 8, 64, 256))
    engine = InferenceEngine(load_bundle(path), device="cpu")
    jb = jax_load_bundle(path)
    for n in (1, 5, 64, 200):
        records = _records(n, seed=n, drift=0.3)
        _assert_response(engine.predict_records(records), jax_engine.predict_records(records),
                         jb, records, PRED_TOL["bf16"] + 1e-6)
    ds = jb.preprocessor.encode(records_to_columns(_records(40, seed=3)))
    parts = [(ds.cat_ids[i:i + 3], ds.numeric[i:i + 3]) for i in range(0, 30, 3)]
    got = engine.fetch_group(engine.dispatch_group_arrays(parts))
    want = jax_engine.fetch_group(jax_engine.dispatch_group_arrays(parts))
    for g, w, i in zip(got, want, range(0, 30, 3)):
        recs = _records(40, seed=3)[i:i + 3]
        _assert_response(g, w, jb, recs, PRED_TOL["bf16"] + 1e-6)
    snap, jsnap = engine.monitor_snapshot(), jax_engine.monitor_snapshot()
    for key in ("rows", "outliers", "batches"):
        assert snap[key] == jsnap[key], key
    np.testing.assert_allclose(snap["drift_sum"], jsnap["drift_sum"], atol=1e-4)


def test_a_failed_snapshot_folds_its_window_back(exact_bundles, monkeypatch):
    """A window whose device -> host fetch fails is merged back into the
    live accumulator: its counts arrive with the next snapshot."""
    engine = InferenceEngine(load_bundle(exact_bundles["linear"]), buckets=(1, 8), device="cpu")
    cat, num = _rows(5, seed=2)
    engine.predict_arrays(cat, num)

    def lost(self):
        raise RuntimeError("device lost")

    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "numpy", lost)
        with pytest.raises(RuntimeError, match="device lost"):
            engine.monitor_snapshot()
    engine.predict_arrays(cat[:3], num[:3])
    snap = engine.monitor_snapshot()
    assert snap["rows"] == 8.0 and snap["batches"] == 2.0


# --------------------------------------------------------------------- http
def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _http(engine):
    server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=0))
    loop = asyncio.new_event_loop()
    srv = loop.run_until_complete(server.start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        loop.call_soon_threadsafe(srv.close)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
        server.close()

    return srv.sockets[0].getsockname()[1], stop


def test_http_golden_response_matches_jax_warm_engine(
    warm_engine, tiny_pipeline, sample_request
):
    """The JAX package's warmed engine (a trained mlp bundle, exact tier)
    and the port serving the same bundle over HTTP."""
    bundle_dir = tiny_pipeline[1].bundle_dir
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu")
    engine.warmup()
    port, stop = _http(engine)
    try:
        for records in (sample_request, _records(7, seed=11, drift=0.5)):
            status, body = _request(port, "POST", "/predict", json.dumps(records).encode())
            assert status == 200
            _assert_response(json.loads(body), warm_engine.predict_records(records),
                             warm_engine.bundle, records, PRED_TOL["bf16"] + 1e-6)
    finally:
        stop()


@pytest.mark.parametrize("name", ["linear", "mlp-ens8"])
def test_http_responses_match_the_jax_engine(exact_bundles, sample_request, name):
    path = exact_bundles[name]
    jax_engine = JaxEngine(jax_load_bundle(path), buckets=(1, 8, 64))
    engine = InferenceEngine(load_bundle(path), buckets=(1, 8, 64), device="cpu")
    engine.warmup()
    port, stop = _http(engine)
    try:
        records = _records(12, seed=21, drift=0.3)
        status, body = _request(port, "POST", "/predict", json.dumps(records).encode())
        assert status == 200
        _assert_response(json.loads(body), jax_engine.predict_records(records),
                         jax_load_bundle(path), records, PRED_TOL["bf16"] + 1e-6)
    finally:
        stop()


# ------------------------------------------------------------ predict-file
def _run(entry, argv, capsys):
    capsys.readouterr()
    assert entry(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_file_prints_what_jax_prints(exact_bundles, tmp_path, capsys, name):
    columns, _ = jax_synthetic(300, seed=8, drift=0.2)
    csv = tmp_path / "rows.csv"
    jax_write_csv(csv, columns)
    args = ["predict-file", f"data.train_path={csv}",
            f"serve.model_directory={exact_bundles[name]}", "serve.max_batch=256"]
    want = _run(jax_main, args, capsys)
    got = _run(main, args + ["serve.device=cpu"], capsys)
    assert sorted(got) == sorted(want)
    _assert_response(got, want, jax_load_bundle(exact_bundles[name]),
                     [{k: columns[k][i] for k in columns} for i in range(300)],
                     PRED_TOL["bf16"] + 1e-6)


def test_cli_serves_the_exact_tier_by_default(exact_bundles, tmp_path):
    import os
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = tmp_path / "server.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={exact_bundles['mlp']}", f"serve.port={port}",
             "serve.host=127.0.0.1", "serve.device=cpu", "serve.warmup_batch_sizes=1,8"],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
            stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log.read_text()
            try:
                if _request(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)
        records = _records(3, 9)
        status, body = _request(port, "POST", "/predict", json.dumps(records).encode())
        assert status == 200 and len(json.loads(body)["predictions"]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert "tier=exact" in log.read_text()


# ------------------------------------------------------------ C1 refusal
@pytest.mark.parametrize("token_dim,heads", [(96, 4), (48, 2), (256, 1)])
def test_a_head_dim_without_a_flash_kernel_is_refused_where_the_model_is_built(token_dim, heads):
    """The doc model (S = 140 >= the flash threshold) at head_dim 24, 24 or
    256 is refused on the card before any forward, naming the head_dim and
    ROADMAP C1; on the CPU (the plain route) it builds."""
    kw = dict(family="bert", doc_records=3, token_dim=token_dim, heads=heads, depth=1)
    config = ModelConfig(**kw)
    with pytest.raises(ValueError, match=f"head_dim {token_dim // heads}.*C1"):
        build_doc_model(config, "cuda")
    with pytest.raises(ValueError, match="C1"):
        check_doc_attention(config, "cuda")
    build_doc_model(config, "cpu")
    # Short documents (S = 94) take the dense route on the card too.
    check_doc_attention(ModelConfig(**dict(kw, doc_records=2)), "cuda")


@pytest.mark.parametrize("token_dim,heads", [(64, 8), (256, 8), (128, 1), (64, 4)])
def test_the_head_dims_with_kernels_build_for_the_card(token_dim, heads):
    """head_dim 8 (the default token_dim 64 over 8 heads), 32, 128 and 16."""
    build_doc_model(
        ModelConfig(family="bert", doc_records=3, token_dim=token_dim, heads=heads, depth=1),
        "cuda",
    )
