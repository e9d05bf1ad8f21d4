"""The mixture-of-experts family (``mlops_tpu_torch/models/moe.py``)
against the JAX package's (``mlops_tpu/models/moe.py``), on the CPU.

Small models (token_dim 16, depth 2, 4 heads, 4 experts, F = 64), weights
from the flax ``init`` plus seeded numpy noise, carried across by
``exact_params_from_numpy``; inputs made by numpy from a seed. Tolerances:

- the FFN, block and model outputs against the flax apply: f32 1e-5 of
  the output's scale (the same f32 arithmetic in another summation
  order); bf16 four bf16 ulps at the value's magnitude (taken as at least
  1) of the eager or the jitted apply, whichever is nearer, the exact
  tier's logit tolerance (``test_torch_transformers.py`` says why);
- the routing masks: exact, except on tokens whose second and third f32
  gates lie within 1e-6 of each other, where ``jax.lax.top_k`` and
  ``torch.topk`` may pick different experts on f32 router products that
  differ in their last bits; those tokens are counted and reported, and
  must stay under 1 % of the tokens;
- the auxiliary against the sown ``aux_losses``: 1e-6 (f32 means of the
  same gates);
- the gradients of ``training_loss`` at dropout 0 against
  ``jax.grad``: cosine >= 0.98 and norms within 5 %, per parameter at f32
  (measured worst 4e-7 off in norm) and over the whole gradient at bf16;
  the loss 1e-5 (f32) and 2e-2 (bf16). In bf16 the router reads the bf16
  LayerNorm output, which the two frameworks round differently in the
  last bit on some elements; where a token's second and third gates are
  that close its route flips, and on this 64-row batch that moves a few
  small leaves by more than the bound (measured at seed 8: the router
  bias of a 2-member ensemble at cosine 0.946, a categorical embedding
  9.6 % in norm) while the whole gradient stays at cosine 0.9996 and
  0.8 % in norm;
- the stacked sweep of a moe group against the JAX ``run_hpo`` fed its
  own init and batches (``tests/torch_hpo_seams.py``): metrics 1e-4,
  the winner's params 1e-5 except the attention key bias, as in
  ``test_torch_hpo.py``;
- bundles trained by either package and served by the other's engine:
  predictions bf16 1.6e-2 plus 1e-6 for the responses' rounding.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.bundle import save_bundle as jax_save_bundle
from mlops_tpu.config import HPOConfig as JaxHPOConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.models import moe as jax_moe
from mlops_tpu.monitor import state as jstate
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train import hpo as jax_hpo
from mlops_tpu.train.loop import fit as jax_fit
from mlops_tpu.train.loop import training_loss as jax_training_loss
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig, load_config
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.models import moe
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.train import hpo
from mlops_tpu_torch.train.loop import training_loss
from mlops_tpu_torch.train.pipeline import run_training
from mlops_tpu_torch.weights import exact_params_from_numpy, flatten_tree, load_params
from torch_hpo_seams import jax_seams, split
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

DIM, DEPTH, HEADS, EXPERTS = 16, 2, 4, 4
PRED_TOL = 1.6e-2 + 1e-6
TIE_GAP = 1e-6
GRAD_COSINE_MIN = 0.98
GRAD_NORM_RTOL = 0.05
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _kw(precision="bf16", **extra):
    return dict(family="moe", token_dim=DIM, depth=DEPTH, heads=HEADS,
                num_experts=EXPERTS, precision=precision, **extra)


def _noisy(params, seed):
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32), params
    )


def _jax_params(kw, seed=0):
    model = jax_build_model(JaxModelConfig(**kw))
    params = jax.jit(lambda key: jax_init_params(model, key))(jax.random.PRNGKey(seed))
    return model, _noisy(params["params"], seed)


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


def _nearer_err(got, eager, jitted, precision):
    return np.minimum(
        np.abs(got - eager) / _tol(eager, precision),
        np.abs(got - jitted) / _tol(jitted, precision),
    )


# ------------------------------------------------------------------ models
def test_the_port_builds_flax_param_names_and_shapes():
    _, params = _jax_params(_kw())
    want = {k: np.asarray(v).shape for k, v in flatten_tree(params).items()}
    got = {k: tuple(v.shape) for k, v in build_model(ModelConfig(**_kw())).state_dict().items()}
    assert got == want
    assert got["block_1.MoEFeedForward_0.experts_in"] == (EXPERTS, DIM, 4 * DIM)
    assert got["block_0.MoEFeedForward_0.router.kernel"] == (DIM, EXPERTS)


def _ffn_pair(precision, seed):
    jdt, tdt = DTYPES[precision]
    jffn = jax_moe.MoEFeedForward(num_experts=EXPERTS, token_dim=DIM, dtype=jdt)
    x = np.random.default_rng(seed).normal(size=(12, 24, DIM)).astype(np.float32)
    params = _noisy(jax.jit(lambda k: jffn.init(k, x, train=False))(
        jax.random.PRNGKey(seed))["params"], seed)
    tffn = moe.MoEFeedForward(EXPERTS, DIM, tdt)
    load_params(tffn, exact_params_from_numpy(params, "cpu"))
    return jffn, tffn, params, x


def _block_pair(precision, seed):
    jdt, tdt = DTYPES[precision]
    jblock = jax_moe.MoEBlock(heads=HEADS, token_dim=DIM, num_experts=EXPERTS,
                              dropout=0.0, dtype=jdt)
    x = np.random.default_rng(seed).normal(size=(12, 24, DIM)).astype(np.float32)
    params = _noisy(jax.jit(lambda k: jblock.init(k, x, train=False))(
        jax.random.PRNGKey(seed))["params"], seed)
    tblock = moe.MoEBlock(HEADS, DIM, EXPERTS, tdt)
    load_params(tblock, exact_params_from_numpy(params, "cpu"))
    return jblock, tblock, params, x


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("part", ["ffn", "block", "model"])
def test_outputs_match_the_flax_apply(part, precision):
    if part == "model":
        kw = _kw(precision)
        jmod, params = _jax_params(kw, seed=3)
        tmod = _port_model(kw, params)
        args = _rows(96, seed=4)
    else:
        jmod, tmod, params, x = (_ffn_pair if part == "ffn" else _block_pair)(precision, 5)
        args = (x,)
    eager = np.asarray(jmod.apply({"params": params}, *args, train=False), np.float32)
    jitted = np.asarray(jax.jit(
        lambda p, *a: jmod.apply({"params": p}, *a, train=False))(params, *args), np.float32)
    with torch.inference_mode():
        out = tmod(*(torch.from_numpy(a) for a in args), train=False)
    got = (out[0] if isinstance(out, tuple) else out).float().numpy()
    assert got.shape == eager.shape
    err = _nearer_err(got, eager, jitted, precision)
    assert (err <= 1.0).all(), err.max()


def test_eval_returns_the_logits_alone_and_training_the_auxiliary():
    kw = _kw("f32")
    _, params = _jax_params(kw, seed=3)
    model = _port_model(kw, params)
    cat, num = (torch.from_numpy(a) for a in _rows(8, seed=4))
    with torch.no_grad():
        plain = model(cat, num)
        logits, aux = model(cat, num, train=True, generator=torch.Generator().manual_seed(0))
    assert isinstance(plain, torch.Tensor) and plain.shape == (8,)
    assert logits.shape == (8,) and aux.shape == (DEPTH,)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_masks_match_except_near_ties(seed):
    jffn, tffn, params, x = _ffn_pair("f32", seed)
    router = params["router"]
    tokens = x.reshape(-1, DIM)
    gates = jax.nn.softmax(tokens @ router["kernel"] + router["bias"], axis=-1)
    _, top = jax.lax.top_k(gates, 2)
    want = np.asarray(jax.nn.one_hot(top, EXPERTS).sum(-2))
    with torch.no_grad():
        tgates, mask, weights = tffn.route(torch.from_numpy(tokens))
    ordered = np.sort(tgates.numpy(), axis=-1)[:, ::-1]
    tie = (ordered[:, 1] - ordered[:, 2]) < TIE_GAP
    print(f"seed {seed}: {int(tie.sum())} of {len(tie)} tokens within {TIE_GAP} of a tie")
    assert tie.mean() < 0.01
    np.testing.assert_array_equal(mask.numpy()[~tie], want[~tie])
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates), rtol=0, atol=1e-6)
    assert np.allclose(weights.numpy().sum(-1), 1.0, atol=1e-6)
    assert (mask.numpy().sum(-1) == 2).all()


@pytest.mark.parametrize("members", [0, 2])
def test_the_auxiliary_matches_the_sown_one(members):
    kw = _kw("f32", dropout=0.0, **({"ensemble_size": members} if members else {}))
    jmodel, params = _jax_params(kw, seed=6)
    model = _port_model(kw, params)
    cat, num = _rows(64, seed=7)
    _, state = jax.jit(lambda p: jmodel.apply(
        {"params": p}, cat, num, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["aux_losses"]))(params)
    aux_tree = state["aux_losses"]["member"] if members else state["aux_losses"]
    want = np.stack([
        np.asarray(aux_tree[f"block_{i}"]["MoEFeedForward_0"]["moe_load_balance"][0])
        for i in range(DEPTH)
    ], axis=-1)
    with torch.no_grad():
        _, aux = model(torch.from_numpy(cat), torch.from_numpy(num), train=True,
                       generator=torch.Generator().manual_seed(0))
    assert aux.shape == ((members,) if members else ()) + (DEPTH,)
    np.testing.assert_allclose(aux.numpy(), want, rtol=0, atol=1e-6)


# --------------------------------------------------------------- gradients
def _cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("members", [0, 2])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gradients_match_jax_grad_of_training_loss(precision, members):
    kw = _kw(precision, dropout=0.0, **({"ensemble_size": members} if members else {}))
    jmodel, params = _jax_params(kw, seed=8)
    cat, num = _rows(64, seed=9)
    lab = (np.random.default_rng(10).random(64) < 0.3).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jax_training_loss(jmodel, p, cat, num, lab, jax.random.PRNGKey(0), 2.0)
    ))(params)
    model = _port_model(kw, params).train()
    loss = training_loss(model, torch.from_numpy(cat), torch.from_numpy(num),
                         torch.from_numpy(lab), torch.Generator().manual_seed(0), 2.0)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= (1e-5 if precision == "f32" else 2e-2)
    grads = {k: p.grad.numpy().ravel() for k, p in model.named_parameters()}
    want = {k: w.ravel() for k, w in
            flatten_tree(jax.tree_util.tree_map(np.asarray, want)).items()}
    assert set(grads) == set(want)
    if precision == "bf16":
        # One vector: a token whose routing flips moves its own rows.
        grads = {"all": np.concatenate([grads[k] for k in sorted(want)])}
        want = {"all": np.concatenate([want[k] for k in sorted(want)])}
    for k, w in want.items():
        g = grads[k]
        if np.linalg.norm(w) < 1e-8:  # e.g. an attention key bias: zero analytically
            assert np.linalg.norm(g) < 1e-5, k
            continue
        assert _cosine(g, w) >= GRAD_COSINE_MIN, (k, _cosine(g, w))
        ratio = np.linalg.norm(g) / np.linalg.norm(w)
        assert abs(ratio - 1) <= GRAD_NORM_RTOL, (k, ratio)


# ------------------------------------------------------------------- sweep
def test_a_stacked_sweep_of_a_moe_group_matches_the_jax_sweep():
    (jtrain, jvalid), (ptrain, pvalid) = split()
    kw = _kw("f32", dropout=0.0)
    jmc, pmc = JaxModelConfig(**kw), ModelConfig(**kw)
    jhc, phc = JaxHPOConfig(trials=3, steps=6), HPOConfig(trials=3, steps=6)
    want = jax_hpo.run_hpo(jmc, JaxTrainConfig(batch_size=32), jhc, jtrain, jvalid)
    got = hpo.run_hpo(
        pmc, TrainConfig(batch_size=32, device="cpu"), phc, ptrain, pvalid, device="cpu",
        **jax_seams(jmc, jhc, 32, jtrain.n, sha=False),
    )
    assert got.best_index == want.best_index
    for w, g in zip(want.trials, got.trials):
        assert g["hyperparams"] == w["hyperparams"]
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= 1e-4, (k, g["metrics"][k], v)
    jp = exact_params_from_numpy(jax.tree_util.tree_map(np.asarray, want.best_params), "cpu")
    assert set(jp) == set(got.best_params)
    lr = want.best_hyperparams["learning_rate"]
    travel = 6 * lr * (1 - hpo.B1) / math.sqrt(1 - hpo.B2)  # Adam's largest travel
    for k, w in jp.items():
        err = (got.best_params[k] - w).abs().numpy()
        key_bias = np.zeros(err.shape, bool)
        if k.endswith("qkv.bias"):
            key_bias[1] = True
        assert err[~key_bias].max(initial=0.0) <= 1e-5, k
        assert err[key_bias].max(initial=0.0) <= travel, k


# ----------------------------------------------------------------- bundles
def _records(n, seed, drift=0.0):
    columns, _ = jax_synthetic(n, seed=seed, drift=drift)
    return [{k: columns[k][i] for k in columns} for i in range(n)]


def _serve_both(path):
    jb = jax_load_bundle(path)
    jax_engine = JaxEngine(jb, buckets=(1, 64))
    engine = InferenceEngine(load_bundle(path), buckets=(1, 64), device="cpu")
    assert engine.serve_tier == "exact"
    for n in (1, 40):
        records = _records(n, seed=n, drift=0.3)
        got, want = engine.predict_records(records), jax_engine.predict_records(records)
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   atol=PRED_TOL, rtol=0)
        assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    records = _records(24, seed=3)
    ds = jb.preprocessor.encode(records_to_columns(records))
    parts = [(ds.cat_ids[i:i + 3], ds.numeric[i:i + 3]) for i in range(0, 24, 3)]
    for g, w in zip(engine.fetch_group(engine.dispatch_group_arrays(parts)),
                    jax_engine.fetch_group(jax_engine.dispatch_group_arrays(parts))):
        np.testing.assert_allclose(g["predictions"], w["predictions"], atol=PRED_TOL, rtol=0)


def test_a_jax_trained_moe_bundle_serves_on_the_port_engine(tmp_path):
    columns, labels = jax_synthetic(600, seed=2)
    prep = JaxPreprocessor.fit(columns)
    ds = prep.encode(columns, labels)
    train, valid = ds.slice(np.arange(500)), ds.slice(np.arange(500, 600))
    kw = _kw()
    jmodel, params = _jax_params(kw, seed=7)
    result = jax_fit(jmodel, train, valid, JaxTrainConfig(
        steps=4, eval_every=4, batch_size=32, warmup_steps=1, learning_rate=1e-2,
    ), init_variables={"params": params})
    jax_save_bundle(tmp_path / "moe", JaxModelConfig(**kw), result.params, prep,
                    jstate.fit_monitor(prep.encode(columns)), calibration={"temperature": 1.3})
    _serve_both(tmp_path / "moe")


def test_a_port_trained_moe_bundle_serves_on_the_jax_engine(tmp_path):
    config = load_config([
        "train.device=cpu", "data.rows=600", "train.steps=4", "train.eval_every=2",
        "train.batch_size=32", "train.distill_bulk=false", "model.family=moe",
        f"model.token_dim={DIM}", f"model.depth={DEPTH}", f"model.heads={HEADS}",
        f"model.num_experts={EXPERTS}",
        f"registry.root={tmp_path / 'registry'}", f"registry.run_root={tmp_path / 'runs'}",
    ])
    result = run_training(config, run_name="t")
    manifest = json.loads((result.bundle_dir / "manifest.json").read_text())
    assert manifest["model_config"]["family"] == "moe"
    _serve_both(result.bundle_dir)
