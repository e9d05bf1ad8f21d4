"""The port's distillation (``mlops_tpu_torch.train.distill``), its gates
(``lifecycle.promote``) and the bundles' bulk tier, against the JAX
package's, on the CPU.

The deterministic pieces take the same inputs (numpy from a seed; the
JAX f32 master carried across by ``weights.quant_master_from_numpy``):

- ``quantize_student``: int8 weights bit-exact, scales 1e-7, the bf16
  embed bit-exact;
- the quantized student's logits (``_quant_logits_chunked``): 1e-5; the
  master's logits and the MSE's gradients: 1e-5;
- ``fit_temperature``: 1e-4; ``expected_calibration_error`` and
  ``roc_auc_np``: 1e-6; ``quant_tier_gates``: the same decision and
  reasons;
- ``teacher_logits`` of the JAX fixture's teacher: probabilities within
  ``PRED_TOL`` (bf16 1.6e-2);
- the port's ``Adam`` against ``optax.adam`` on the same gradients, three
  steps: 1e-7.

The fits draw other index streams than jax.random's, so a student is
held by its fidelity: the port's and the JAX package's ``roc_auc_delta``
within 0.01 for both students on the same split and teacher, and each
``mean_abs_prob_delta`` at most 0.05.

Bundles cross: a port-written bundle with both students is read by the
JAX ``load_bundle`` and scored by the JAX ``score_dataset`` on the
distilled and quant paths within the bulk tolerances
(``test_torch_bulk.py``); ``run_training`` writes the ``bulk`` block for
an ensemble and a small FT-Transformer at the default ``distill_bulk``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import LifecycleConfig as JaxLifecycleConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.data.encode import EncodedDataset as JaxEncodedDataset
from mlops_tpu.lifecycle import promote as jpromote
from mlops_tpu.ops import quant as jquant
from mlops_tpu.parallel import bulk as jbulk
from mlops_tpu.train import calibrate as jcalibrate
from mlops_tpu.train import distill as jdistill
from mlops_tpu.train.pipeline import split_dataset as jax_split
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import (
    LifecycleConfig,
    LifecycleConfigError,
    ModelConfig,
    load_config,
)
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.lifecycle import promote
from mlops_tpu_torch.ops import quant
from mlops_tpu_torch.parallel import bulk
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train import calibrate, distill
from mlops_tpu_torch.train.pipeline import run_training, split_dataset
from mlops_tpu_torch.weights import bulk_student_from_numpy, quant_master_from_numpy
from torch_students import (
    DRIFT_ATOL,
    PRED_TOL,
    assert_flags_match,
    jax_config,
    rows,
    train_jax_bundle,
)

AUC_DELTA_GAP = 0.01
MAX_MEAN_PROB_DELTA = 0.05


def _master(seed=3):
    """The JAX init of the quant master plus seeded noise, as numpy."""
    master = jax.device_get(jquant.init_quant_master(seed))
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + 0.3 * rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in master.items()}


def _ds(n, seed):
    cat, num = rows(n, seed, SCHEMA.cards)
    return JaxEncodedDataset(cat, num), EncodedDataset(cat, num)


# ------------------------------------------------------ deterministic pieces
def test_quantize_student_is_bit_exact():
    master = _master()
    want = jax.device_get(jquant.quantize_student(master))
    got = quant.quantize_student(master)
    assert set(got) == set(want)
    for key in ("w1_q", "w2_q"):
        assert got[key].dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("w1_s", "w2_s", "b1", "b2"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-7)
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  np.asarray(want["embed"], np.float32))
    assert quant.quant_params_geometry(got) == jquant.quant_params_geometry(want) == (4, 32)


def test_quant_logits_match():
    master = _master()
    jds, tds = _ds(5000, seed=7)
    want = jdistill._quant_logits_chunked(jquant.quantize_student(master), jds, chunk=2048)
    got = distill._quant_logits_chunked(quant.quantize_student(master), tds, "cpu", chunk=2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_master_logits_and_their_gradients_match():
    master = _master()
    cat, num = rows(512, seed=8, cards=SCHEMA.cards)
    target = np.random.default_rng(9).normal(size=512).astype(np.float32)

    def jax_loss(p):
        pred = jquant.master_student_logits(p, jnp.asarray(cat), jnp.asarray(num))
        return jnp.mean(jnp.square(pred - target))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(master)
    port = {k: v.requires_grad_() for k, v in quant_master_from_numpy(master, "cpu").items()}
    loss = torch.mean(torch.square(
        quant.master_student_logits(port, torch.from_numpy(cat), torch.from_numpy(num))
        - torch.from_numpy(target)))
    grads = torch.autograd.grad(loss, list(port.values()))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * max(1.0, float(want_loss))
    for (key, _), grad in zip(port.items(), grads):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grads[key]), rtol=0, atol=1e-5)


def test_adam_matches_optax_adam():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    optimizer = optax.adam(3e-3)
    state = optimizer.init(params)
    want = params
    leaves = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    adam = distill.Adam(leaves, 3e-3)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = optimizer.update(grads, state)
        want = optax.apply_updates(want, updates)
        adam.step([torch.from_numpy(grads[k]) for k in ("a", "b")])
    for key, leaf in zip(("a", "b"), leaves):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[key]), rtol=0, atol=1e-7)


def test_temperature_ece_and_auc_match():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=3000) * 2.0).astype(np.float32)
    labels = (rng.random(3000) < 1.0 / (1.0 + np.exp(-1.3 * logits))).astype(np.float32)
    t_port = calibrate.fit_temperature(logits, labels)
    t_jax = jcalibrate.fit_temperature(logits, labels)
    assert abs(t_port - t_jax) <= 1e-4
    probs = 1.0 / (1.0 + np.exp(-logits / t_jax))
    assert abs(promote.expected_calibration_error(probs, labels)
               - jpromote.expected_calibration_error(probs, labels)) <= 1e-6
    assert abs(promote.roc_auc_np(logits, labels) - jpromote.roc_auc_np(logits, labels)) <= 1e-6
    ties = np.round(logits)  # average ranks for ties
    assert abs(promote.roc_auc_np(ties, labels) - jpromote.roc_auc_np(ties, labels)) <= 1e-6
    assert promote.roc_auc_np(logits[:0], labels[:0]) == jpromote.roc_auc_np(logits[:0], labels[:0])


@pytest.mark.parametrize(
    "fidelity",
    [
        {"roc_auc_delta": -0.001, "ece": 0.02},
        {"roc_auc_delta": -0.05, "ece": 0.02},
        {"roc_auc_delta": 0.01, "ece": 0.3},
        {"roc_auc_delta": -0.2, "ece": 0.3},
        {"mean_abs_prob_delta": 0.01},
    ],
)
def test_quant_tier_gates_decide_as_the_jax_gates(fidelity):
    for bounds in ({}, {"max_auc_drop": 0.1, "max_ece": 0.5}):
        got = promote.quant_tier_gates(fidelity, LifecycleConfig(**bounds))
        want = jpromote.quant_tier_gates(fidelity, JaxLifecycleConfig(**bounds))
        assert got.passed == want.passed
        assert got.reasons == want.reasons
        assert got.as_dict() == want.as_dict()


def test_lifecycle_config_validates_as_the_jax_config():
    bad = dict(drift_threshold=0.0, tick_s=0.0, breaker_failures=0)
    with pytest.raises(LifecycleConfigError) as port_err:
        LifecycleConfig(**bad).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxLifecycleConfig(**bad).validate()
    assert str(port_err.value) == str(jax_err.value)
    assert [f.name for f in dataclasses.fields(LifecycleConfig)] == [
        f.name for f in dataclasses.fields(JaxLifecycleConfig)]


# ------------------------------------------------------------ the fixture
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX fixture's bundle and the same training split in both
    packages (same synthetic rows, preprocessor and seed-2024 split)."""
    root = tmp_path_factory.mktemp("distill")
    bundle_dir = train_jax_bundle(root)
    config = jax_config(root)
    columns, labels = jax_synthetic(config.data.rows, seed=config.data.seed)
    jtrain, jvalid = jax_split(JaxPreprocessor.fit(columns).encode(columns, labels),
                               config.data.valid_fraction)
    tcols, tlabels = generate_synthetic(config.data.rows, seed=config.data.seed)
    train, valid = split_dataset(Preprocessor.fit(tcols).encode(tcols, tlabels),
                                 config.data.valid_fraction)
    np.testing.assert_array_equal(train.cat_ids, jtrain.cat_ids)
    np.testing.assert_array_equal(valid.numeric, jvalid.numeric)
    return bundle_dir, (jtrain, jvalid), (train, valid)


def test_teacher_logits_match(jax_run):
    bundle_dir, (_, jvalid), (_, valid) = jax_run
    jb = jax_load_bundle(bundle_dir)
    want = jdistill.teacher_logits(jb.model, jb.variables, jvalid)
    got = distill.teacher_logits(load_bundle(bundle_dir).model, valid, "cpu").numpy()
    sig = lambda z: 1.0 / (1.0 + np.exp(-z.astype(np.float64)))  # noqa: E731
    np.testing.assert_allclose(sig(got), sig(want), rtol=0,
                               atol=PRED_TOL[jb.model_config.precision])


def test_the_jax_bulk_student_carries_across(jax_run):
    """The JAX fixture's bulk student, by the numpy bridge and by the
    port's ``load_bundle``: the same weights, and logits within four bf16
    ulps of the flax apply (``tests/test_torch_exact.py``'s bound)."""
    bundle_dir, _, _ = jax_run
    jb = jax_load_bundle(bundle_dir)
    tree = jax.tree_util.tree_map(np.asarray, jb.bulk_variables["params"])
    config = ModelConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in json.loads((bundle_dir / "manifest.json").read_text())["bulk"][
            "model_config"].items()})
    bridged = bulk_student_from_numpy(config, tree, "cpu")
    loaded = load_bundle(bundle_dir).bulk_model
    for name, value in loaded.state_dict().items():
        assert torch.equal(value, bridged.state_dict()[name]), name
    cat, num = rows(256, seed=5, cards=SCHEMA.cards)
    want = np.asarray(jb.bulk_model.apply(jb.bulk_variables, cat, num, train=False))
    with torch.inference_mode():
        got = bridged(torch.from_numpy(cat), torch.from_numpy(num)).numpy()
    tol = 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
    assert (np.abs(got - want) <= tol).all()


def test_both_fits_reach_the_jax_fidelity(jax_run):
    bundle_dir, _, (train, valid) = jax_run
    manifest = json.loads((bundle_dir / "manifest.json").read_text())
    teacher = load_bundle(bundle_dir).model
    bulk_fit = distill.distill_for_bulk(
        teacher, load_bundle(bundle_dir).model_config, train, valid, device="cpu")
    quant_fit = distill.distill_quant_student(teacher, train, valid, device="cpu")
    for got, want in ((bulk_fit.fidelity, manifest["bulk"]["fidelity"]),
                      (quant_fit.fidelity, manifest["quant"]["fidelity"])):
        assert set(got) == set(want)
        assert abs(got["roc_auc_delta"] - want["roc_auc_delta"]) <= AUC_DELTA_GAP
        assert got["mean_abs_prob_delta"] <= MAX_MEAN_PROB_DELTA
        assert want["mean_abs_prob_delta"] <= MAX_MEAN_PROB_DELTA
        assert got["teacher_roc_auc"] == pytest.approx(want["teacher_roc_auc"], abs=2e-3)
    assert bulk_fit.student_config == dataclasses.replace(
        load_bundle(bundle_dir).model_config, family="mlp", ensemble_size=1,
        hidden_dims=(64, 64), dropout=0.0)
    assert set(quant_fit.gates) == set(manifest["quant"]["gates"])
    assert quant_fit.gates["passed"] == promote.quant_tier_gates(
        quant_fit.fidelity, LifecycleConfig()).passed
    assert quant_fit.temperature == calibrate.fit_temperature(
        distill._quant_logits_chunked(quant_fit.qparams, valid, "cpu").numpy(),
        np.asarray(valid.labels, np.float32))


# ----------------------------------------------------------- bundles cross
@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    """The same small ensemble trained by the port's ``run_training``
    with the default ``distill_bulk`` and ``distill_quant=true``."""
    root = tmp_path_factory.mktemp("port_students")
    config = load_config([
        "train.device=cpu", "data.rows=4000", "model.hidden_dims=32,32",
        "model.embed_dim=4", "model.ensemble_size=4", "train.steps=150",
        "train.eval_every=150", "train.batch_size=256", "train.distill_quant=true",
        f"registry.root={root / 'registry'}", f"registry.run_root={root / 'runs'}",
    ])
    return run_training(config, register=False).bundle_dir


def test_a_port_bundle_with_both_students_reads_in_jax(port_bundle):
    manifest = json.loads((port_bundle / "manifest.json").read_text())
    assert set(manifest["bulk"]) == {"model_config", "fidelity"}
    assert set(manifest["quant"]) == {"format", "fidelity", "temperature", "gates"}
    assert manifest["quant"]["gates"]["passed"] is True
    jb, tb = jax_load_bundle(port_bundle), load_bundle(port_bundle)
    assert jb.has_bulk and tb.has_bulk and jb.has_quant and tb.has_quant
    assert jb.bulk_fidelity == tb.bulk_fidelity
    assert jb.quant_gates_passed and tb.quant_gates_passed
    flat = tb.bulk_variables
    for name, leaf in jax.tree_util.tree_flatten_with_path(jb.bulk_variables["params"])[0]:
        key = ".".join(p.key for p in name)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy())
    columns, _ = generate_synthetic(9000, seed=12)
    ds = tb.preprocessor.encode(columns)
    jds = JaxEncodedDataset(ds.cat_ids, ds.numeric)
    for kw, tol in ((dict(exact=False), PRED_TOL["bf16"]),
                    (dict(tier="quant"), PRED_TOL["f32"])):
        want = jbulk.score_dataset(jb, jds, chunk_rows=4096, **kw)
        got = bulk.score_dataset(tb, ds, chunk_rows=4096, device="cpu", **kw)
        assert got.path == want.path
        np.testing.assert_allclose(got.predictions, want.predictions, rtol=0, atol=tol)
        assert_flags_match(got.outliers, want.outliers, ds.numeric, tb.monitor.to_arrays())
        for k, v in want.feature_drift.items():
            assert abs(got.feature_drift[k] - v) <= DRIFT_ATOL, k


def test_run_training_distills_a_transformer_family(tmp_path):
    config = load_config([
        "train.device=cpu", "data.rows=1500", "model.family=ft_transformer",
        "model.depth=1", "model.token_dim=16", "model.heads=2", "train.steps=20",
        "train.eval_every=20", "train.batch_size=128",
        f"registry.root={tmp_path / 'registry'}", f"registry.run_root={tmp_path / 'runs'}",
    ])
    assert config.train.distill_bulk is True
    result = run_training(config, register=False)
    manifest = json.loads((result.bundle_dir / "manifest.json").read_text())
    assert manifest["bulk"]["model_config"]["family"] == "mlp"
    assert manifest["bulk"]["model_config"]["hidden_dims"] == [64, 64]
    assert "quant" not in manifest
    assert (result.bundle_dir / "bulk_params.msgpack").exists()
    assert jax_load_bundle(result.bundle_dir).has_bulk
    assert load_bundle(result.bundle_dir).has_bulk


@pytest.mark.parametrize(
    "overrides,match",
    [
        (["model.family=moe"], "A9"),
        (["model.family=gbm"], "A8"),
        (["train.init_params=pretrained.msgpack"], "A9"),
    ],
)
def test_the_other_refusals_stay(tmp_path, overrides, match):
    config = load_config(["train.device=cpu", f"registry.run_root={tmp_path / 'runs'}",
                          *overrides])
    with pytest.raises(ValueError, match=match):
        run_training(config)
    assert not (tmp_path / "runs").exists()


def test_score_and_lifecycle_tables_load():
    config = load_config(["score.chunk_rows=4096", "score.streaming=true",
                          "lifecycle.max_ece=0.2"])
    assert config.score.chunk_rows == 4096 and config.score.streaming is True
    assert config.lifecycle.max_ece == 0.2
