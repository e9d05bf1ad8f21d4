"""The port's dense single-record trainer (the exact tier) against the
JAX package's ``train/loop.py`` and ``run_training``, on the CPU.

Small models (linear; mlp hidden (32, 32, 16), embed 4; a 4-member mlp
ensemble at hidden (16, 8); FT-Transformer and single-record BERT at
token_dim 16, depth 2, 4 heads), weights from the flax ``init`` plus
seeded numpy noise, carried across by ``exact_params_from_numpy``;
inputs made by numpy from a seed or by the JAX package's synthetic data.
Tolerances:

- one step's loss and gradients against ``jax.value_and_grad`` of the
  JAX ``training_loss`` (dropout 0, ``train=True``, pos_weight 3): f32
  loss 1e-6 relative and each gradient leaf within 1e-5 of its largest
  magnitude (the same f32 arithmetic in another order); bf16 the loss
  within 1e-2 relative, and per leaf a cosine of at least 0.99 and a norm
  ratio within 3 % (bf16 products rounded at other places);
- the optimizer against ``optax.chain(clip_by_global_norm(1),
  adamw(warmup_cosine_decay_schedule(...)))`` over 20 steps: schedule
  values within 1e-7 relative, params within 1e-6 of each leaf's largest
  magnitude (measured worst 1.43e-6 at magnitudes near 2 after 20 steps:
  ``torch.optim.AdamW`` applies the decay ``p * (1 - lr * wd)`` as a
  rounding of its own, optax folds it into the one update). Over the job's whole 2,000-step schedule the values
  agree within two f32 ulps (2.4e-7 relative): XLA's f32 cosine is not
  correctly rounded at some arguments (measured worst 1.78e-7 at 9 of the
  2,000 steps), the port's is;
- dropout: the zero share within 3 sigma of p over 1e5 elements, kept
  values exactly ``x / (1 - p)``;
- ``init_params`` against the flax init of the same module: constant
  leaves exact; each random leaf's mean within 3 sigma of the two
  samples' difference and its std within 5 % or 3 sigma;
- ``fit`` against the JAX ``fit`` (the JAX package's ``_train_tiny``:
  mlp (64, 64), embed 8, 4,000 synthetic rows, 300 steps): the mean
  validation AUC of three seeds within 0.03. JAX's own runs over seeds
  0-2 span 0.0032, over seeds 0-10 0.038 with a std of 0.0115 (measured
  on this test's data), so the difference of two three-seed means has a
  std of about 0.0094: 0.03 is 3.2 of it;
- resume: bit for bit on the CPU;
- the CLI's bundle served by the JAX engine against the port's CPU
  engine: predictions 1.6e-2 + 1e-6 (bf16), drift 1e-5, flags exact off
  the threshold band.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train import loop as jax_loop
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig, TrainConfig, load_config
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.models.layers import MultiHeadSelfAttention, dropout
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.train import loop
from mlops_tpu_torch.train.pipeline import run_training
from mlops_tpu_torch.weights import exact_params_from_numpy, flatten_tree, load_params
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROOT = Path(__file__).resolve().parent.parent
JOB = ROOT / "configs" / "train_register_job.toml"
FAMILIES = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4),
    "mlp-ens4": dict(family="mlp", hidden_dims=(16, 8), embed_dim=4, ensemble_size=4),
    "ft_transformer": dict(family="ft_transformer", token_dim=16, depth=2, heads=4),
    "bert": dict(family="bert", token_dim=16, depth=2, heads=4),
}
POS_WEIGHT = 3.0
AUC_EPS = 0.03
PRED_TOL = 1.6e-2 + 1e-6
FLAG_BAND = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The models here are tiny: a few torch threads beside XLA's own pool
    run them faster than one per core competing with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_params(kw, seed=0):
    model = jax_build_model(JaxModelConfig(**kw))
    params = jax.jit(lambda key: jax_init_params(model, key))(jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32),
        params,
    )
    return model, params


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, n) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    num = rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(n) < 0.3).astype(np.float32)
    return cat, num, lab


def _dataset(rows, seed):
    columns, labels = jax_synthetic(rows, seed=seed)
    prep = JaxPreprocessor.fit(columns)
    ds = prep.encode(columns, labels)
    return EncodedDataset(ds.cat_ids, ds.numeric, ds.labels)


# ------------------------------------------------------ one step's gradients
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_one_step_loss_and_gradients_match_jax(name, precision):
    kw = dict(FAMILIES[name], precision=precision, dropout=0.0)
    jmodel, params = _jax_params(kw, seed=1)
    cat, num, lab = _rows(64, seed=2)
    loss_of = lambda p: jax_loop.training_loss(  # noqa: E731
        jmodel, p, cat, num, lab, jax.random.PRNGKey(0), POS_WEIGHT
    )
    want_loss, want = jax.jit(jax.value_and_grad(loss_of))(params)
    want = {k: np.asarray(v, np.float64) for k, v in flatten_tree(want).items()}

    model = build_model(ModelConfig(**kw))
    load_params(model, exact_params_from_numpy(params, "cpu"))
    loss = loop.training_loss(
        model, *(torch.from_numpy(a) for a in (cat, num, lab)), None, POS_WEIGHT
    )
    loss.backward()
    got = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    if precision == "f32":
        assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
        for k, w in want.items():
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(got[k] - w).max() <= 1e-5 * scale, k
        return
    assert abs(loss.item() - float(want_loss)) <= 1e-2 * abs(float(want_loss))
    for k, w in want.items():
        g = got[k].ravel()
        w = w.ravel()
        gn, wn = np.linalg.norm(g), np.linalg.norm(w)
        if wn == 0.0:
            assert gn == 0.0, k
            continue
        assert np.dot(g, w) / (gn * wn) >= 0.99, k
        assert abs(gn / wn - 1) <= 0.03, k


def test_an_ensemble_trains_on_its_member_logits():
    kw = dict(FAMILIES["mlp-ens4"], precision="f32", dropout=0.0)
    _, params = _jax_params(kw)
    model = load_params(build_model(ModelConfig(**kw)), exact_params_from_numpy(params, "cpu"))
    cat, num, lab = (torch.from_numpy(a) for a in _rows(16, seed=3))
    with torch.no_grad():
        members = model(cat, num, train=True)
        per_member = torch.stack([loop.sigmoid_bce(m, lab) for m in members]).mean()
        loss = loop.training_loss(model, cat, num, lab)
    assert members.shape == (4, 16)
    assert abs(float(loss) - float(per_member)) <= 1e-6
    assert model(cat, num).shape == (16,)


# ---------------------------------------------------------------- optimizer
def _optax_chain(config):
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, config.learning_rate, config.warmup_steps,
        max(config.steps, config.warmup_steps + 1), config.learning_rate * 0.05,
    )
    fields = {k: v for k, v in dataclasses.asdict(config).items() if k != "device"}
    return schedule, jax_loop.make_optimizer(JaxTrainConfig(**fields))


def test_the_optimizer_matches_the_optax_chain_step_for_step():
    config = TrainConfig(steps=20, warmup_steps=5, learning_rate=3e-3, weight_decay=1e-4)
    schedule, tx = _optax_chain(dataclasses.replace(config))
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)

    @jax.jit
    def update(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = loop.make_optimizer(module, config)
    norms = []
    for step in range(20):
        # Global norms alternate above and below the clip's 1.0.
        scale = 2.0 if step % 2 else 0.05
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        norms.append(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))
        want_lr = float(schedule(jnp.asarray(step, jnp.int32)))
        assert abs(opt.schedule(step) - want_lr) <= 1e-7 * max(abs(want_lr), 1e-30), step
        jparams, state = update(jparams, state, {k: jnp.asarray(g) for k, g in grads.items()})
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        assert opt.adamw.param_groups[0]["lr"] == opt.schedule(step)
        for k, p in module.named_parameters():
            want = np.asarray(jparams[k])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (k, step + 1, err)
        if step == 0:  # optax's first update uses lr(0) = 0
            for k, p in module.named_parameters():
                assert np.array_equal(p.detach().numpy(), params[k])
    assert min(norms) < 1.0 < max(norms)
    assert opt.state_dict()["count"] == 20


def test_the_job_schedule_matches_optax_within_two_ulps():
    config = load_config([], JOB).train
    schedule, _ = _optax_chain(config)
    want = np.asarray(jax.vmap(schedule)(jnp.arange(config.steps + 10, dtype=jnp.int32)))
    got = np.asarray([loop.lr_schedule(config)(t) for t in range(config.steps + 10)], np.float32)
    assert got[0] == want[0] == 0.0
    rel = np.abs(got[1:] - want[1:]) / np.abs(want[1:])
    assert rel.max() <= 2.4e-7
    assert (rel == 0).mean() >= 0.99


# ------------------------------------------------------------------ dropout
def test_dropout_statistics():
    p = 0.3
    x = torch.full((100_000,), 1.5, dtype=torch.bfloat16)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    zeros = float((y == 0).float().mean())
    assert abs(zeros - p) <= 3 * np.sqrt(p * (1 - p) / x.numel())
    kept = y[y != 0]
    assert kept.dtype == torch.bfloat16
    assert torch.equal(kept, torch.full_like(kept, 1.5) / (1 - p))
    assert dropout(x, p, None) is x  # eval
    assert dropout(x, 0.0, torch.Generator()) is x
    a = dropout(x, p, torch.Generator().manual_seed(5))
    assert torch.equal(a, dropout(x, p, torch.Generator().manual_seed(5)))


def test_ensemble_members_draw_their_own_masks():
    kw = dict(FAMILIES["mlp-ens4"], precision="f32", dropout=0.5)
    model = init_params(build_model(ModelConfig(**kw)), 0)
    with torch.no_grad():  # every member the same weights as member 0
        for p in model.parameters():
            p.copy_(p[:1].expand_as(p))
    cat, num, _ = (torch.from_numpy(a) for a in _rows(32, seed=4))
    with torch.no_grad():
        evals = model.member(cat, num)
        trains = model(cat, num, train=True, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(evals[0], evals[k]) for k in range(1, 4))
    assert not any(torch.equal(trains[0], trains[k]) for k in range(1, 4))


def test_attention_weight_dropout_acts_on_the_probabilities():
    torch.manual_seed(0)
    mha = MultiHeadSelfAttention(16, 4, torch.float32, dropout=0.4)
    with torch.no_grad():
        for p in mha.parameters():
            p.normal_()
    x = torch.randn(3, 24, 16)
    with torch.no_grad():
        got = mha(x, generator=torch.Generator().manual_seed(7))
        plain = mha(x)
        # The same draw over the probabilities, by hand.
        qkv = mha.qkv(x.reshape(-1, 16)).reshape(3, 24, 3, 4, 4)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.5, dim=-1)
        probs = dropout(probs, 0.4, torch.Generator().manual_seed(7))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        want = mha.out(out.reshape(-1, 16)).reshape(3, 24, 16)
    assert torch.allclose(got, want, atol=1e-6)
    assert not torch.allclose(got, plain, atol=1e-3)


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("name", ["mlp-ens4", "ft_transformer", "bert", "moe"])
def test_init_params_follows_the_flax_init(name):
    seed = 0
    if name == "moe":  # the experts [E, D, F] = [8, 64, 256]: N(0, 0.02)
        kw = dict(family="moe", token_dim=64, heads=8, depth=1, num_experts=8)
        # Seed 1: at seed 0 the 64 values of flax's own ``cls`` draw have a
        # std 19 % under 0.02, which puts the port's draw (12 % over) at
        # 3.01 sigma of the two samples' ratio; every other leaf is inside.
        seed = 1
    elif name in ("ft_transformer", "bert"):
        kw = dict(FAMILIES[name], token_dim=64, heads=8, depth=1)
    else:
        kw = dict(FAMILIES[name], hidden_dims=(64, 32))
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray,
        jax.jit(lambda key: jax_init_params(jax_build_model(JaxModelConfig(**kw)), key))(
            jax.random.PRNGKey(seed))["params"],
    ))
    got = {k: v.detach().numpy() for k, v in init_params(
        build_model(ModelConfig(**kw)), seed=seed).state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.std() == 0.0:  # zeros and ones
            assert np.array_equal(g, w), k
            continue
        n = w.size
        assert abs(g.mean() - w.mean()) <= 3 * w.std() * np.sqrt(2.0 / n), k
        ratio = g.std() / w.std()
        assert abs(ratio - 1) <= max(0.05, 3 * np.sqrt(1.0 / n)), (k, ratio)
    if name == "mlp-ens4":  # members drawn independently
        stem = got["member.stem.kernel"]
        assert not np.array_equal(stem[0], stem[1])


# -------------------------------------------------------------- fit vs JAX
TINY_FIT = dict(
    batch_size=256, steps=300, eval_every=100, checkpoint_every=100,
    learning_rate=3e-3, warmup_steps=20,
)


def test_fit_reaches_the_jax_fit_auc():
    columns, labels = jax_synthetic(4000, seed=5)
    ds = JaxPreprocessor.fit(columns).encode(columns, labels)
    split = int(0.8 * ds.n)
    tr, va = ds.slice(np.arange(split)), ds.slice(np.arange(split, ds.n))
    kw = dict(family="mlp", hidden_dims=(64, 64), embed_dim=8)
    jax_aucs, port_aucs = [], []
    for seed in range(3):
        jres = jax_loop.fit(jax_build_model(JaxModelConfig(**kw)), tr, va,
                            JaxTrainConfig(seed=seed, **TINY_FIT))
        jax_aucs.append(jres.metrics["validation_roc_auc_score"])
        res = loop.fit(
            build_model(ModelConfig(**kw)),
            EncodedDataset(tr.cat_ids, tr.numeric, tr.labels),
            EncodedDataset(va.cat_ids, va.numeric, va.labels),
            TrainConfig(seed=seed, device="cpu", **TINY_FIT),
        )
        port_aucs.append(res.metrics["validation_roc_auc_score"])
        assert res.steps == 300 and len(res.history) == 3
        assert set(res.history[-1]) == set(jres.history[-1])
    assert abs(np.mean(port_aucs) - np.mean(jax_aucs)) <= AUC_EPS, (port_aucs, jax_aucs)
    assert min(port_aucs) > 0.75


# ------------------------------------------------------- keep_best, resume
SMALL = dict(batch_size=64, eval_every=10, checkpoint_every=20, warmup_steps=5,
             device="cpu")


@pytest.fixture(scope="module")
def small_data():
    ds = _dataset(1200, seed=6)
    return ds.slice(np.arange(1000)), ds.slice(np.arange(1000, 1200))


def _fit(data, tmp, steps=60, learning_rate=1e-2):
    model_kw = dict(family="mlp", hidden_dims=(16, 16), embed_dim=4, dropout=0.2)
    return loop.fit(
        build_model(ModelConfig(**model_kw)), *data,
        TrainConfig(steps=steps, learning_rate=learning_rate, **SMALL),
        metrics_path=tmp / "metrics.jsonl", checkpoint_dir=tmp / "ckpt",
    )


def test_keep_best_packages_the_best_window(small_data, tmp_path):
    res = _fit(small_data, tmp_path, learning_rate=5e-2)
    aucs = [r["validation_roc_auc_score"] for r in res.history]
    best = res.history[int(np.argmax(aucs))]
    assert res.packaged_step == best["step"]
    assert res.metrics == {k: v for k, v in best.items() if k.startswith("validation_")}
    # A rerun of the finished run restores the best snapshot from disk.
    again = _fit(small_data, tmp_path, learning_rate=5e-2)
    assert again.history == [] and again.packaged_step == res.packaged_step
    assert again.metrics == res.metrics
    for k, v in res.params.items():
        assert torch.equal(again.params[k], v), k


class _Interrupt(Exception):
    pass


def test_a_resumed_run_equals_the_straight_run_bit_for_bit(small_data, tmp_path, monkeypatch):
    straight = _fit(small_data, tmp_path / "straight")
    real = loop.batch_indices

    def interrupt_at_31(n, batch, seed, step):
        if step == 31:  # after the step-30 row, before its checkpoint
            raise _Interrupt
        return real(n, batch, seed, step)

    monkeypatch.setattr(loop, "batch_indices", interrupt_at_31)
    with pytest.raises(_Interrupt):
        _fit(small_data, tmp_path / "resumed")
    monkeypatch.setattr(loop, "batch_indices", real)
    resumed = _fit(small_data, tmp_path / "resumed")
    assert [r["step"] for r in resumed.history] == [30, 40, 50, 60]
    assert resumed.history == straight.history[2:]
    assert resumed.metrics == straight.metrics
    assert resumed.packaged_step == straight.packaged_step
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k

    def journal(run):
        rows = [json.loads(line) for line in (tmp_path / run / "metrics.jsonl").open()]
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    assert [r["step"] for r in journal("resumed")] == [10, 20, 30, 40, 50, 60]
    assert journal("resumed") == journal("straight")


# ----------------------------------------------------------------- the CLI
def test_train_cli_on_the_job_toml_writes_a_bundle_both_packages_serve(tmp_path, capsys):
    args = [
        "train", "--config", str(JOB), "train.device=cpu", "data.rows=3000",
        "train.steps=30", "train.eval_every=10", "train.batch_size=128",
        "model.hidden_dims=(32,32)", f"registry.root={tmp_path / 'registry'}",
        f"registry.run_root={tmp_path / 'runs'}", "registry.run_name=job",
    ]
    capsys.readouterr()
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"bundle", "model_uri", "run_dir", "steps", "packaged_step", "metrics"}
    assert out["steps"] == 30 and out["model_uri"] == "models:/credit-default-uci-custom/1"
    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [10, 20, 30]
    best = max(rows, key=lambda r: r["validation_roc_auc_score"])
    assert out["packaged_step"] == best["step"]
    assert out["metrics"] == {k: v for k, v in best.items() if k.startswith("validation_")}
    assert set(rows[0]) == {"ts", "step", "train_loss", *out["metrics"]}

    jb, tb = jax_load_bundle(out["bundle"]), load_bundle(out["bundle"])
    assert jb.model_config.family == tb.model_config.family == "mlp"
    assert tb.manifest["calibration"]["temperature"] == jb.manifest["calibration"]["temperature"]
    columns, _ = jax_synthetic(64, seed=8, drift=0.3)
    records = [{k: columns[k][i] for k in columns} for i in range(64)]
    want = JaxEngine(jb, buckets=(64,)).predict_records(records)
    got = InferenceEngine(tb, buckets=(64,), device="cpu").predict_records(records)
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=PRED_TOL, rtol=0)
    g = np.asarray(list(got["feature_drift_batch"].values()))
    w = np.asarray(list(want["feature_drift_batch"].values()))
    np.testing.assert_allclose(g, w, atol=1e-5 + 1e-6, rtol=0)
    ds = tb.preprocessor.encode(records_to_columns(records))
    diff = ds.numeric.astype(np.float64) - np.asarray(jb.monitor.out_mean, np.float64)
    d2 = np.einsum("ni,ij,nj->n", diff, np.asarray(jb.monitor.out_precision, np.float64), diff)
    off = np.abs(d2 - float(jb.monitor.out_threshold)) > FLAG_BAND * float(jb.monitor.out_threshold)
    assert np.array_equal(np.asarray(got["outliers"])[off], np.asarray(want["outliers"])[off])


@pytest.mark.parametrize("family", ["ft_transformer", "bert"])
def test_run_training_trains_the_transformer_families(tmp_path, family):
    config = load_config([
        "train.device=cpu", "data.rows=600", "train.steps=4", "train.eval_every=2",
        "train.batch_size=32", "train.distill_bulk=false", f"model.family={family}",
        "model.token_dim=16", "model.depth=1", "model.heads=2",
        f"registry.root={tmp_path / 'registry'}", f"registry.run_root={tmp_path / 'runs'}",
    ], JOB)
    result = run_training(config, run_name="t")
    assert result.train_result.steps == 4
    jb = jax_load_bundle(result.bundle_dir)
    assert jb.model_config.family == family
    cat, num, _ = _rows(8, seed=9)
    want = np.asarray(jax.jit(lambda v, c, x: jb.model.apply(v, c, x, train=False))(
        jb.variables, cat, num))
    with torch.inference_mode():
        got = load_bundle(result.bundle_dir).model(torch.from_numpy(cat), torch.from_numpy(num))
    tol = 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
    assert (np.abs(got.numpy() - want) <= tol).all()


# ---------------------------------------------------------------- refusals
_CUT_TRANSFORMER = ["data.rows=600", "train.steps=4", "train.eval_every=2",
                    "train.batch_size=32", "model.token_dim=16", "model.depth=1",
                    "model.heads=2", "model.num_experts=4"]


@pytest.mark.parametrize(
    "overrides,match",
    [
        # A9 is ported: init_params on the job's mlp is refused with the
        # JAX package's message, before any work; a moe model and an
        # ensemble of transformer members train (cut to a few steps at
        # token_dim 16) into flax bundles the JAX package loads.
        pytest.param(["train.init_params=pretrained.msgpack"], "shares no trunk",
                     id="overrides0-A9"),
        pytest.param(["model.family=moe", "train.distill_bulk=false", *_CUT_TRANSFORMER],
                     None, id="overrides1-A9"),
        pytest.param(["model.family=ft_transformer", "model.ensemble_size=2",
                      "train.distill_bulk=false", *_CUT_TRANSFORMER], None,
                     id="overrides2-A9"),
        # The tree families are ported: they train (on a cut of the job's
        # rows) into an sklearn bundle the JAX package loads.
        pytest.param(["model.family=gbm", "data.rows=1500", "model.n_estimators=10"],
                     None, id="overrides3-A8"),
        pytest.param(["model.family=rf", "data.rows=1500", "model.n_estimators=10"],
                     None, id="overrides4-A8"),
        (["model.doc_records=3", "model.family=bert"], "run_layout_training"),
    ],
)
def test_run_training_refuses_what_is_not_ported_before_any_work(tmp_path, overrides, match):
    config = load_config(
        ["train.device=cpu", f"registry.run_root={tmp_path / 'runs'}",
         f"registry.root={tmp_path / 'registry'}", *overrides], JOB
    )
    if match is None:
        result = run_training(config, register=False)
        manifest = json.loads((result.bundle_dir / "manifest.json").read_text())
        jb = jax_load_bundle(result.bundle_dir)
        assert jb.model_config.family == config.model.family
        if config.model.family in ("gbm", "rf"):
            assert manifest["flavor"] == "sklearn"
            assert load_bundle(result.bundle_dir).estimator.family == config.model.family
            return
        assert manifest["flavor"] == "flax"
        assert jb.model_config.ensemble_size == config.model.ensemble_size
        cat, num, _ = _rows(8, seed=9)
        want = np.asarray(jax.jit(lambda v, c, x: jb.model.apply(v, c, x, train=False))(
            jb.variables, cat, num))
        with torch.inference_mode():
            got = load_bundle(result.bundle_dir).model(torch.from_numpy(cat),
                                                       torch.from_numpy(num))
        tol = 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
        assert (np.abs(got.numpy() - want) <= tol).all()
        return
    with pytest.raises(ValueError, match=match):
        run_training(config)
    assert not (tmp_path / "runs").exists()


TAKEN = ["train.device=cpu", "data.rows=600", "train.steps=4", "train.eval_every=2",
         "train.batch_size=32", "model.hidden_dims=16", "model.embed_dim=4"]


@pytest.mark.parametrize("case", ["tensorboard", "parquet", "gs_registry"])
def test_run_training_takes_tensorboard_parquet_and_a_gs_registry(tmp_path, monkeypatch, case):
    """What the port refused until it had them: TensorBoard events beside
    metrics.jsonl, a Parquet file trained on as its CSV twin is (params
    equal bit for bit), and a ``gs://`` registry the JAX package reads."""
    from mlops_tpu.bundle.registry import ModelRegistry as JaxRegistry
    from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
    from mlops_tpu_torch.data.parquet import write_parquet_columns
    from torch_gcs import install_fake_bucket

    def train(*extra, name="run"):
        config = load_config([*TAKEN, f"registry.root={tmp_path / 'registry'}",
                              f"registry.run_root={tmp_path / 'runs'}", *extra], JOB)
        return run_training(config, run_name=name)

    if case == "tensorboard":
        result = train(f"train.tensorboard_dir={tmp_path / 'tb'}")
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
        rows = (result.run_dir / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(r)["step"] for r in rows] == [2, 4]
    elif case == "parquet":
        pytest.importorskip("pyarrow")
        columns, labels = generate_synthetic(600, seed=4)
        write_csv_columns(tmp_path / "rows.csv", columns, labels)
        write_parquet_columns(tmp_path / "rows.parquet", columns, labels)
        bundles = [train(f"data.train_path={tmp_path / f'rows.{kind}'}", name=kind).bundle_dir
                   for kind in ("csv", "parquet")]
        for name in ("params.msgpack", "preprocess.npz", "monitor.npz"):
            assert (bundles[0] / name).read_bytes() == (bundles[1] / name).read_bytes(), name
    else:
        install_fake_bucket(monkeypatch, tmp_path / "home")
        result = train("registry.root=gs://bucket/models")
        assert result.model_uri == "models:/credit-default-uci-custom/1"
        resolved = JaxRegistry("gs://bucket/models").resolve("credit-default-uci-custom", "1")
        assert (resolved / "params.msgpack").read_bytes() == \
            (result.bundle_dir / "params.msgpack").read_bytes()
        assert jax_load_bundle(resolved).model_config.family == "mlp"


def test_train_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    for extra in ([], ["train.device=cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", "--config", str(JOB), *extra, f"registry.run_root={tmp_path}"])
    assert not any(tmp_path.iterdir())
