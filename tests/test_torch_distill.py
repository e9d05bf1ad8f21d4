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

Port-trained bundles crossing to the JAX package are
``test_torch_distill_port.py``'s (a file of their own, so the parallel
run spreads the two fixtures' training).
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
from mlops_tpu.train import calibrate as jcalibrate
from mlops_tpu.train import distill as jdistill
from mlops_tpu.train.pipeline import split_dataset as jax_split
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import (
    LifecycleConfig,
    LifecycleConfigError,
    ModelConfig,
)
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.lifecycle import promote
from mlops_tpu_torch.ops import quant
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train import calibrate, distill
from mlops_tpu_torch.train.pipeline import split_dataset
from mlops_tpu_torch.weights import bulk_student_from_numpy, quant_master_from_numpy
from torch_students import PRED_TOL, jax_config, rows, train_jax_bundle
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

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
