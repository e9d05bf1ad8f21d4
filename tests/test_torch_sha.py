"""The port's successive halving (``mlops_tpu_torch/train/hpo.py
run_sha``) against the JAX package's ``run_sha``, on the CPU: every
family the sweep takes, 3 trials over 2 rungs (survivor counts 3 and 1,
6 steps a rung, the schedule spanned over 12), the EMA on and off, fed
the JAX sweep's per-trial initial params and per-step indices
(``tests/torch_hpo_seams.py``). Tolerances are ``test_torch_hpo.py``'s;
the trial records' hyperparams, rung and steps must be equal, and the
eliminated trials must carry the metrics they died with. The transformer
families run in ``test_torch_sha_transformers.py`` (each file about a
minute on the CPU)."""

import numpy as np
import pytest
import torch

from mlops_tpu.train import hpo as jax_hpo
from mlops_tpu_torch.config import TrainConfig
from mlops_tpu_torch.train import hpo
from test_torch_hpo import BATCH, assert_sweeps_agree, jax_train_config
from torch_hpo_seams import hpo_configs, jax_seams, model_configs, split
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

SHA = dict(trials=3, steps=8, strategy="sha", eta=3, sha_rungs=2)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return split()


def test_the_plan_is_the_jax_plan():
    for kw in (SHA, dict(trials=10, steps=1000, strategy="sha"),
               dict(trials=8, steps=200, strategy="sha", eta=2, sha_rungs=4),
               dict(trials=1, steps=5, strategy="sha", eta=1, sha_rungs=0)):
        cfg = hpo_configs(**kw)[1]
        counts, rung_steps, horizon = hpo.sha_plan(cfg)
        n0, eta, rungs = cfg.trials, max(2, cfg.eta), max(1, cfg.sha_rungs)
        want = [max(1, n0 // eta**r) for r in range(rungs)]
        assert counts == want
        assert rung_steps == max(1, (n0 * cfg.steps) // sum(want))
        assert horizon == rung_steps * rungs
        assert sum(c * rung_steps for c in counts) <= n0 * cfg.steps


def check_sha_against_jax(data, name, ema):
    (jtrain, jvalid), (ptrain, pvalid) = data
    jmc, pmc = model_configs(name)
    jhc, phc = hpo_configs(**SHA)
    want = jax_hpo.run_hpo(jmc, jax_train_config(ema), jhc, jtrain, jvalid)
    got = hpo.run_hpo(
        pmc, TrainConfig(batch_size=BATCH, ema_decay=ema, device="cpu"), phc,
        ptrain, pvalid, device="cpu",
        **jax_seams(jmc, jhc, BATCH, jtrain.n, sha=True),
    )
    _, rung_steps, horizon = hpo.sha_plan(phc)
    assert_sweeps_agree(want, got, phc, horizon, horizon, with_rung=True)
    # One finalist trained the whole horizon; the others died at rung 0.
    rungs = sorted((t["rung"], t["steps"]) for t in got.trials)
    assert rungs == [(0, rung_steps), (0, rung_steps), (1, horizon)]
    assert got.trials[got.best_index]["steps"] == horizon


@pytest.mark.parametrize("name,ema", [("linear", 0.0), ("mlp", 0.9), ("mlp-ens2", 0.0)])
def test_successive_halving_matches_the_jax_sweep(data, name, ema):
    check_sha_against_jax(data, name, ema)


def test_survivors_keep_their_optimizer_state(data):
    """A survivor continued from the gathered state equals the same trial
    trained straight through alone (its rows and masks are keyed by its
    own key and the global step, so the rung boundary changes nothing)."""
    _, (ptrain, pvalid) = data
    pmc = model_configs("mlp")[1]
    tc = TrainConfig(batch_size=BATCH, ema_decay=0.9, device="cpu")
    hp = hpo.sample_hyperparams(hpo_configs(trials=3)[1])
    seeds = hpo.trial_seeds(4, 3)
    sweep = hpo.SweepData.put(ptrain, pvalid, "cpu")
    cpu = torch.device("cpu")
    stack = hpo.TrialStack(pmc, tc, hp, seeds, 12, sweep, cpu)
    stack.run(6)
    stack.keep(np.asarray([2, 0])[::-1][:1])  # a reversed view, as argsort[::-1] gives
    assert stack.trial_ids.tolist() == [0]
    stack.run(6)
    alone = hpo.TrialStack(pmc, tc, {k: v[:1] for k, v in hp.items()}, seeds[:1], 12, sweep, cpu)
    alone.run(12)
    torch.testing.assert_close(stack.eval_params(), alone.eval_params(), rtol=0, atol=1e-6)
    torch.testing.assert_close(stack.mu, alone.mu, rtol=0, atol=1e-6)
