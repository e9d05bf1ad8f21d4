"""Deep ensembles of transformer members (``DeepEnsemble`` over
``ft_transformer``, ``bert`` and ``moe`` built with a member axis)
against the JAX package's ``nn.vmap`` ensemble, on the CPU.

Small members (token_dim 16, depth 2, 4 heads; the moe with 4 experts),
3 members, weights from the flax ``init`` plus seeded numpy noise,
carried across by ``exact_params_from_numpy`` (the vmapped ``[K, ...]``
axis maps onto the port's stacked parameters as it is); inputs made by
numpy from a seed. Tolerances:

- eval logits (the logit of the mean member probability) and the
  training forward's member logits ``[K, N]`` at dropout 0 against the
  flax apply: f32 1e-5 of the logits' scale (of the jitted apply); bf16
  four bf16 ulps at the logit's magnitude (at least 1) of the eager or
  the jitted apply, whichever is nearer, the exact tier's logit
  tolerance;
- one step's gradients of ``training_loss`` against ``jax.value_and_grad``
  at f32, dropout 0: each leaf within 1e-5 of its largest magnitude, the
  loss 1e-6 relative (the moe auxiliary included);
- a member alone (its slice of every stacked parameter loaded into the
  single-member module) gives that member's logits: 1e-6 at f32;
- dropout draws per member: members with equal parameters give different
  training logits under one generator, and equal ones in eval;
- an ensemble bundle served on the port's exact tier against the JAX
  engine: predictions bf16 1.6e-2 plus 1e-6 for the responses' rounding.
"""

import jax
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.monitor import state as jstate
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train.loop import training_loss as jax_training_loss
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data import Preprocessor
from mlops_tpu_torch.models import DeepEnsemble, build_model
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.train.loop import training_loss
from mlops_tpu_torch.weights import (
    exact_params_from_numpy,
    flatten_tree,
    load_params,
    monitor_from_numpy,
)
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

K = 3
FAMILIES = ("ft_transformer", "bert", "moe")
PRED_TOL = 1.6e-2 + 1e-6


def _kw(family, precision="bf16", **extra):
    kw = dict(family=family, token_dim=16, depth=2, heads=4, precision=precision,
              ensemble_size=K, dropout=0.0)
    if family == "moe":
        kw["num_experts"] = 4
    return {**kw, **extra}


def _jax_params(kw, seed=0):
    model = jax_build_model(JaxModelConfig(**kw))
    params = jax.jit(lambda key: jax_init_params(model, key))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return model, jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32),
        params["params"],
    )


def _port_model(kw, params):
    model = build_model(ModelConfig(**kw))
    return load_params(model, exact_params_from_numpy(params, "cpu")).eval()


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, n) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    return cat, rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32)


def _tol(want, precision):
    if precision == "f32":
        return 1e-5 * max(1.0, float(np.abs(want).max()))
    return 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("family", FAMILIES)
def test_the_ensemble_builds_the_vmapped_param_tree(family):
    kw = _kw(family)
    _, params = _jax_params(kw)
    model = build_model(ModelConfig(**kw))
    assert isinstance(model, DeepEnsemble) and model.member.members == K
    want = {k: np.asarray(v).shape for k, v in flatten_tree(params).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert all(k.startswith("member.") and v[0] == K for k, v in want.items())


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_the_vmapped_flax_apply(family, precision, train):
    kw = _kw(family, precision)
    jmodel, params = _jax_params(kw, seed=3)
    model = _port_model(kw, params)
    cat, num = _rows(48, seed=4)

    def apply(p):
        out = jmodel.apply({"params": p}, cat, num, train=train,
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           mutable=["aux_losses"] if train else False)
        return _logits(out)

    jitted = np.asarray(jax.jit(apply)(params))
    # f32: the jitted apply alone (the eager one is the same f32 arithmetic)
    eager = np.asarray(apply(params)) if precision == "bf16" else jitted
    with torch.inference_mode():
        got = _logits(model(torch.from_numpy(cat), torch.from_numpy(num), train=train,
                            generator=torch.Generator().manual_seed(0))).numpy()
    assert got.shape == eager.shape == ((K, 48) if train else (48,))
    err = np.minimum(np.abs(got - eager) / _tol(eager, precision),
                     np.abs(got - jitted) / _tol(jitted, precision))
    assert (err <= 1.0).all(), err.max()


@pytest.mark.parametrize("family", FAMILIES)
def test_one_step_gradients_match_jax(family):
    kw = _kw(family, "f32")
    jmodel, params = _jax_params(kw, seed=5)
    cat, num = _rows(32, seed=6)
    lab = (np.random.default_rng(7).random(32) < 0.3).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jax_training_loss(jmodel, p, cat, num, lab, jax.random.PRNGKey(0), 3.0)
    ))(params)
    model = _port_model(kw, params).train()
    loss = training_loss(model, torch.from_numpy(cat), torch.from_numpy(num),
                         torch.from_numpy(lab), torch.Generator().manual_seed(0), 3.0)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    grads = dict(model.named_parameters())
    for k, w in flatten_tree(jax.tree_util.tree_map(np.asarray, want)).items():
        np.testing.assert_allclose(grads[k].grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6), err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_member_is_the_single_model_on_its_slice(family):
    kw = _kw(family, "f32")
    _, params = _jax_params(kw, seed=8)
    ens = _port_model(kw, params)
    single = build_model(ModelConfig(**dict(kw, ensemble_size=1)))
    cat, num = (torch.from_numpy(a) for a in _rows(16, seed=9))
    with torch.no_grad():
        members = _logits(ens(cat, num, train=True))
        for i in range(K):
            load_params(single, {k.removeprefix("member."): v[i]
                                 for k, v in ens.state_dict().items()})
            torch.testing.assert_close(_logits(single(cat, num, train=True)), members[i],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_dropout_draws_per_member(family):
    kw = _kw(family, "f32", dropout=0.3)
    _, params = _jax_params(kw, seed=10)
    # every member the same parameters: member 0's slice everywhere
    same = {k: np.broadcast_to(np.asarray(v)[:1], np.asarray(v).shape).copy()
            for k, v in flatten_tree(params).items()}
    model = build_model(ModelConfig(**kw))
    load_params(model, {k: torch.from_numpy(v) for k, v in same.items()})
    cat, num = (torch.from_numpy(a) for a in _rows(16, seed=11))
    with torch.no_grad():
        trained = _logits(model(cat, num, train=True,
                                generator=torch.Generator().manual_seed(0)))
        plain = model.member(cat, num)
    assert not torch.allclose(trained[0], trained[1])
    assert torch.equal(plain[0], plain[1]) and torch.equal(plain[1], plain[2])


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The JAX preprocessor and monitor of 2,000 synthetic rows, and the
    preprocessor's file, which the port loads."""
    columns, _ = jax_synthetic(2000, seed=0)
    prep = JaxPreprocessor.fit(columns)
    path = tmp_path_factory.mktemp("ensemble_prep") / "prep.npz"
    prep.save(path)
    return path, jstate.fit_monitor(prep.encode(columns))


@pytest.mark.parametrize("family", FAMILIES)
def test_an_ensemble_bundle_serves_on_the_port_engine_like_the_jax_engine(
    tmp_path, fitted, family
):
    prep_path, monitor = fitted
    kw = _kw(family)
    _, params = _jax_params(kw, seed=12)
    save_exact_bundle(tmp_path / "b", ModelConfig(**kw), _port_model(kw, params),
                      Preprocessor.load(prep_path),
                      monitor_from_numpy(monitor.to_arrays(), "cpu"),
                      calibration={"temperature": 1.2})
    jb = jax_load_bundle(tmp_path / "b")
    assert jb.model_config.ensemble_size == K and jb.model_config.family == family
    engine = InferenceEngine(load_bundle(tmp_path / "b"), buckets=(64,), device="cpu")
    jax_engine = JaxEngine(jb, buckets=(64,))
    for n in (1, 40):
        columns, _ = jax_synthetic(n, seed=n)
        records = [{k: columns[k][i] for k in columns} for i in range(n)]
        got, want = engine.predict_records(records), jax_engine.predict_records(records)
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   atol=PRED_TOL, rtol=0)
