"""The port's trial-stacked sweep (``mlops_tpu_torch/train/hpo.py``)
against the JAX package's vmapped one (``mlops_tpu/train/hpo.py``), on
the CPU.

Tiny members of every family the sweep takes (linear; mlp (16, 16),
embed 4; a 2-member mlp ensemble; FT-Transformer and single-record BERT
at token_dim 16, depth 1, 2 heads), f32, dropout 0, 3 trials of 8 steps
at batch 32 on 1,200 training rows of the JAX package's synthetic data.
The port's trainer is fed the JAX sweep's own per-trial initial params
(through the weights bridge) and per-step batch indices, recomputed from
its key derivation (``tests/torch_hpo_seams.py``). Tolerances:

- ``sample_hyperparams``: bit for bit;
- every trial's five validation metrics: 1e-4 (measured worst 6e-8);
- the winner's params: 1e-5 (measured worst 5e-7), except the attention
  key bias of the transformers: its gradient is zero analytically (a
  bias added to every key moves all scores of a query alike), so both
  packages feed Adam float noise, which its normalization turns into
  steps of up to the learning rate. That slice is held within Adam's
  largest possible travel, ``sum_t lr_t * (1 - b1) / sqrt(1 - b2)``
  (measured worst 3.9e-4 against 1.6e-2);
- the optimizer against optax's ``chain(clip_by_global_norm(1),
  adamw(schedule, weight_decay))`` under ``jax.vmap`` on the same
  gradients: 1e-6 of each leaf's magnitude over 12 steps;
- a trial trained beside two others against the same trial alone (mlp
  with dropout, the ensemble, linear): losses and params 1e-6.
"""

import dataclasses
import math
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlops_tpu.config import load_config as jax_load_config
from mlops_tpu.train import hpo as jax_hpo
from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig, load_config
from mlops_tpu_torch.train import hpo
from torch_hpo_seams import hpo_configs, jax_seams, model_configs, split
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROOT = Path(__file__).resolve().parent.parent
TRIALS, STEPS, BATCH = 3, 8, 32
METRIC_TOL = 1e-4
PARAM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return split()


# --------------------------------------------------------- sampling, specs
@pytest.mark.parametrize("kw", [
    {},
    dict(seed=0, trials=3),
    dict(seed=7, trials=32, lr_log10=(-5.0, -1.0)),
    dict(seed=2025, trials=1, wd_log10=(-8.0, -2.5), pos_weight_range=(0.5, 9.0)),
])
def test_sample_hyperparams_is_bit_identical(kw):
    jcfg, pcfg = hpo_configs(**kw)
    want, got = jax_hpo.sample_hyperparams(jcfg), hpo.sample_hyperparams(pcfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _specs():
    doc = tomllib.loads((ROOT / "configs" / "tune_architectures.toml").read_text())
    return doc["hpo"]["architectures"] + [
        "family=linear", "family=bert,token_dim=32,depth=2,heads=4",
        "hidden_dims=64x32x16, dropout=0.2, precision=f32", "ensemble_size=4",
        "seq_parallel=true",
    ]


@pytest.mark.parametrize("spec", _specs())
def test_architecture_specs_parse_as_the_jax_package_parses_them(spec):
    from mlops_tpu.config import ModelConfig as JaxModelConfig

    want = jax_hpo.parse_architecture_spec(spec, JaxModelConfig())
    got = hpo.parse_architecture_spec(spec, ModelConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec", ["nope=1", "hidden_dims", "family=gbm", "family=rf"])
def test_bad_architecture_specs_raise_the_jax_errors(spec):
    from mlops_tpu.config import ModelConfig as JaxModelConfig

    with pytest.raises(ValueError) as want:
        jax_hpo.parse_architecture_spec(spec, JaxModelConfig())
    with pytest.raises(ValueError) as got:
        hpo.parse_architecture_spec(spec, ModelConfig())
    assert str(got.value) == str(want.value)


def test_a_moe_group_is_refused_naming_its_roadmap_item():
    """The moe family is ported (A9): its group parses as the JAX loader
    parses it, where it was refused."""
    from mlops_tpu.config import ModelConfig as JaxModelConfig

    want = jax_hpo.parse_architecture_spec("family=moe,depth=2", JaxModelConfig())
    got = hpo.parse_architecture_spec("family=moe,depth=2", ModelConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == "moe" and got.depth == 2


@pytest.mark.parametrize("raw", [
    "hidden_dims=16,embed_dim=8;family=bert",
    "(hidden_dims=16x16,embed_dim=8 ; family=ft_transformer,depth=2;)",
    "family=linear",
])
def test_the_semicolon_rule_of_string_tuples_parses_as_the_jax_loader(raw):
    overrides = [f"hpo.architectures={raw}", "hpo.lr_log10=-4,-2", "hpo.trials=5"]
    got = load_config(overrides).hpo
    want = jax_load_config(None, overrides=overrides, env={}).hpo
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for spec in got.architectures:
        assert "," not in spec or "=" in spec  # whole specs, not their pairs


@pytest.mark.parametrize("toml", ["train_register_job.toml", "tune_architectures.toml"])
def test_the_hpo_and_registry_tables_load_as_the_jax_package_loads_them(toml):
    path = ROOT / "configs" / toml
    got, want = load_config([], toml_path=path), jax_load_config(path, env={})
    assert dataclasses.asdict(got.hpo) == dataclasses.asdict(want.hpo)
    for field in ("promote_version", "promote_stage", "gc_keep"):
        assert getattr(got.registry, field) == getattr(want.registry, field)


# ------------------------------------------------------------- streams
def test_batch_rows_are_a_function_of_key_and_step():
    keys = torch.as_tensor(hpo.trial_seeds(5, 4)[:, 1])
    step = torch.tensor(17)

    def rows(k, s):
        return hpo.batch_rows(hpo.site_bases(k, s, 3), 4096, 1000)

    a = rows(keys, step)
    assert a.shape == (4, 4096) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    torch.testing.assert_close(rows(keys[2:3], step), a[2:3])
    assert not torch.equal(rows(keys, step + 1), a)
    # Uniform over the rows: each of 10 bins within 5 sigma of 4 x 409.6.
    counts = torch.bincount(a.flatten() // 100, minlength=10).double()
    assert float((counts - 1638.4).abs().max()) < 5 * math.sqrt(1638.4)


def test_the_counter_stream_draws_per_trial_under_vmap():
    keys = torch.as_tensor(hpo.trial_seeds(0, 3)[:, 1])
    bases = hpo.site_bases(keys, torch.tensor(4), 3)

    def draw(base):
        stream = hpo.CounterStream(base)
        return stream.uniform((50, 40), base.device), stream.uniform((7,), base.device)

    batched = torch.func.vmap(draw)(bases)
    for i in range(3):
        alone = draw(bases[i])
        for b, a in zip(batched, alone):
            torch.testing.assert_close(b[i], a, rtol=0, atol=0)
    u = batched[0]
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * math.sqrt(1 / 12 / u.numel())
    assert not torch.equal(u[0], u[1])
    # Neighbouring sites and steps draw apart.
    assert not torch.equal(batched[0][:, :7], batched[1])
    again = torch.func.vmap(draw)(hpo.site_bases(keys, torch.tensor(5), 3))
    assert not torch.equal(again[0], u)


# ------------------------------------------------------ the optimizer
def test_the_stacked_optimizer_is_optax_adamw_under_vmap():
    """12 updates of 3 trials from random gradients: the port's ``apply``
    against optax's chain with the JAX sweep's hand-written schedule,
    vmapped over lr and weight decay."""
    rng = np.random.default_rng(0)
    lr = np.asarray([3e-3, 1e-2, 5e-4], np.float32)
    wd = np.asarray([1e-4, 1e-6, 3e-3], np.float32)
    horizon, steps = 40, 12
    shapes = {"a": (5, 3), "b": (7,)}
    params0 = {k: rng.normal(size=(3, *s)).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.normal(size=(3, *s)) * (0.05 if i % 2 else 2.0)).astype(np.float32)
         for k, s in shapes.items()}
        for i in range(steps)
    ]

    def make(lr_t, wd_t):
        warmup = max(1, horizon // 20)

        def schedule(step):
            step = step.astype(jnp.float32)
            warm = lr_t * step / warmup
            progress = jnp.clip((step - warmup) / max(horizon - warmup, 1), 0.0, 1.0)
            cosine = lr_t * (0.05 + 0.95 * 0.5 * (1.0 + jnp.cos(jnp.pi * progress)))
            return jnp.where(step < warmup, warm, cosine)

        return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=wd_t))

    def one(lr_t, wd_t, p, gs):
        opt = make(lr_t, wd_t)
        state = opt.init(p)
        for i in range(steps):
            u, state = opt.update({k: v[i] for k, v in gs.items()}, state, p)
            p = optax.apply_updates(p, u)
        return p

    want = jax.jit(jax.vmap(one))(
        jnp.asarray(lr), jnp.asarray(wd), params0,
        jax.tree_util.tree_map(lambda *x: jnp.stack(x, 1), *grads),
    )

    class _Stack(hpo.TrialStack):
        def __init__(self):  # just the optimizer's state
            self.names, self.shapes = list(shapes), [shapes[k] for k in shapes]
            self.sizes = [math.prod(s) for s in self.shapes]
            self.flat = torch.cat(
                [torch.from_numpy(params0[k]).reshape(3, -1) for k in shapes], 1
            ).requires_grad_(True)
            self.mu, self.nu = torch.zeros_like(self.flat), torch.zeros_like(self.flat)
            self.decay, self.ema, self.steps_done = 0.0, None, 0
            self.count = torch.zeros((), dtype=torch.int64)
            self.lr, self.wd = torch.from_numpy(lr), torch.from_numpy(wd)
            self.horizon = horizon

    stack = _Stack()
    for g in grads:
        stack.apply(torch.cat([torch.from_numpy(g[k]).reshape(3, -1) for k in shapes], 1))
    got = stack.views(stack.flat.detach())
    for k in shapes:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


# --------------------------------------------- parity with the JAX sweep
def _key_bias_mask(name: str, shape) -> np.ndarray:
    """True on the attention key bias (``qkv.bias[1]``): zero gradient."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        mask[1] = True
    return mask


def _adam_travel(hpo_config, horizon: int, steps: int, lr: float) -> float:
    warmup = max(1, horizon // 20)
    total = 0.0
    for s in range(steps):
        progress = min(max((s - warmup) / max(horizon - warmup, 1), 0.0), 1.0)
        total += lr * s / warmup if s < warmup else lr * (
            0.05 + 0.475 * (1 + math.cos(math.pi * progress)))
    return total * (1 - hpo.B1) / math.sqrt(1 - hpo.B2)


def assert_sweeps_agree(want, got, hpo_config, horizon, steps, with_rung=False):
    """Trial records, metrics, the winner's index and params."""
    assert got.best_index == want.best_index
    assert got.best_hyperparams == want.best_hyperparams
    assert len(got.trials) == len(want.trials)
    for w, g in zip(want.trials, got.trials):
        assert {k: v for k, v in g.items() if k != "metrics"} == {
            k: v for k, v in w.items() if k != "metrics"}
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= METRIC_TOL, (k, g["metrics"][k], v)
        if with_rung:
            assert (g["rung"], g["steps"]) == (w["rung"], w["steps"])
    from mlops_tpu_torch.weights import exact_params_from_numpy

    jp = exact_params_from_numpy(jax.tree_util.tree_map(np.asarray, want.best_params), "cpu")
    assert set(jp) == set(got.best_params)
    travel = _adam_travel(hpo_config, horizon, steps, want.best_hyperparams["learning_rate"])
    for k, w in jp.items():
        err = (got.best_params[k] - w).abs().numpy()
        mask = _key_bias_mask(k, err.shape)
        assert err[~mask].max(initial=0.0) <= PARAM_TOL, k
        assert err[mask].max(initial=0.0) <= travel, k


@pytest.mark.parametrize("name,ema", [
    ("linear", 0.9), ("mlp", 0.0), ("mlp-ens2", 0.9), ("ft_transformer", 0.0),
    ("bert", 0.9),
])
def test_random_search_matches_the_jax_sweep(data, name, ema):
    (jtrain, jvalid), (ptrain, pvalid) = data
    jmc, pmc = model_configs(name)
    jhc, phc = hpo_configs(trials=TRIALS, steps=STEPS)
    want = jax_hpo.run_hpo(
        jmc, jax_train_config(ema), jhc, jtrain, jvalid
    )
    got = hpo.run_hpo(
        pmc, TrainConfig(batch_size=BATCH, ema_decay=ema, device="cpu"), phc,
        ptrain, pvalid, device="cpu",
        **jax_seams(jmc, jhc, BATCH, jtrain.n, sha=False),
    )
    assert_sweeps_agree(want, got, phc, STEPS, STEPS)


def jax_train_config(ema: float):
    from mlops_tpu.config import TrainConfig as JaxTrainConfig

    return JaxTrainConfig(batch_size=BATCH, ema_decay=ema)


# ---------------------------------------------------- trial independence
@pytest.mark.parametrize("name", ["linear", "mlp", "mlp-ens2"])
def test_a_trial_trained_beside_others_equals_it_trained_alone(data, name):
    """Dropout on (the mlp's 0.3): each trial draws its own masks and
    rows from (its key, the step), wherever it sits in the stack."""
    _, (ptrain, pvalid) = data
    mc = dataclasses.replace(model_configs(name)[1], dropout=0.3)
    tc = TrainConfig(batch_size=BATCH, ema_decay=0.5, device="cpu")
    hp = hpo.sample_hyperparams(HPOConfig(trials=3))
    seeds = hpo.trial_seeds(1, 3)
    sweep_data = hpo.SweepData.put(ptrain, pvalid, "cpu")
    cpu = torch.device("cpu")
    stack = hpo.TrialStack(mc, tc, hp, seeds, 12, sweep_data, cpu)
    losses = stack.run(12)
    alone = hpo.TrialStack(
        mc, tc, {k: v[1:2] for k, v in hp.items()}, seeds[1:2], 12, sweep_data, cpu
    )
    alone_losses = alone.run(12)
    torch.testing.assert_close(alone_losses[:, 0], losses[:, 1], rtol=0, atol=1e-6)
    torch.testing.assert_close(alone.eval_params()[0], stack.eval_params()[1], rtol=0, atol=1e-6)
    assert not torch.allclose(losses[:, 0], losses[:, 1])


# ------------------------------------------------------------- selection
def test_a_nan_trial_never_wins_and_all_nan_raises_the_jax_error(data, monkeypatch):
    objective = np.asarray([0.7, np.nan, 0.9, np.inf * 0])
    assert hpo.select_best(objective, "roc_auc") == 2
    assert hpo.select_best(np.asarray([np.nan, 0.1]), "roc_auc") == 1
    # All non-finite: the JAX sweep's own error, from both packages.
    (jtrain, jvalid), (ptrain, pvalid) = data
    jmc, pmc = model_configs("linear")
    jhc, phc = hpo_configs(trials=2, steps=2)

    def nan_auc(real):
        def metrics(*args, **kwargs):
            out = dict(real(*args, **kwargs))
            out["roc_auc"] = out["roc_auc"] * float("nan")
            return out
        return metrics

    monkeypatch.setattr(jax_hpo, "binary_metrics", nan_auc(jax_hpo.binary_metrics))
    monkeypatch.setattr(hpo, "binary_metrics", nan_auc(hpo.binary_metrics))
    with pytest.raises(RuntimeError) as want:
        jax_hpo.run_hpo(jmc, jax_train_config(0.0), jhc, jtrain, jvalid)
    with pytest.raises(RuntimeError) as got:
        hpo.run_hpo(pmc, TrainConfig(batch_size=BATCH, device="cpu"), phc,
                    ptrain, pvalid, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("all 2 trials produced non-finite roc_auc: [nan, nan]")


def test_one_nan_trial_is_passed_over(data, monkeypatch):
    _, (ptrain, pvalid) = data
    _, pmc = model_configs("linear")
    real = hpo.TrialStack.metrics

    def first_nan(self, flat):
        out = real(self, flat)
        out["roc_auc"][int(np.argmax(out["roc_auc"]))] = np.nan
        return out

    monkeypatch.setattr(hpo.TrialStack, "metrics", first_nan)
    res = hpo.run_hpo(pmc, TrainConfig(batch_size=BATCH, device="cpu"),
                      HPOConfig(trials=3, steps=4), ptrain, pvalid, device="cpu")
    aucs = [t["metrics"]["validation_roc_auc_score"] for t in res.trials]
    assert sum(np.isnan(aucs)) == 1
    assert res.best_index == int(np.nanargmax(aucs))


def test_an_unknown_strategy_is_refused_with_the_jax_message(data):
    _, (ptrain, pvalid) = data
    with pytest.raises(ValueError, match="hpo.strategy must be 'random' or 'sha', not 'tpe'"):
        hpo.run_hpo(model_configs("linear")[1], TrainConfig(device="cpu"),
                    HPOConfig(strategy="tpe"), ptrain, pvalid, device="cpu")
