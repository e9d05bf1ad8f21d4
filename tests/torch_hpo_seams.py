"""Shared by the port's sweep tests (``test_torch_hpo.py``,
``test_torch_sha.py``, ``test_torch_tune.py``): the JAX sweep's own
per-trial initial params and per-step batch indices, recomputed from its
key derivation, for the port's trainer to be fed.

``run_hpo`` splits ``PRNGKey(seed)`` into one key per trial and splits
each again into an init key and a loop key (``mlops_tpu/train/hpo.py:157,
168``); ``run_sha`` initializes and loops on the trial's key itself
(:394, :349, :364). A step's indices come from the first half of
``split(fold_in(loop_key, step))`` (:201-203, :364-366), the global step
counted from 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mlops_tpu.config import HPOConfig as JaxHPOConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.train.pipeline import split_dataset as jax_split
from mlops_tpu_torch.config import HPOConfig, ModelConfig
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.weights import exact_params_from_numpy

# Tiny members of every family the sweep takes, f32, dropout 0.
FAMILIES = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(16, 16), embed_dim=4),
    "mlp-ens2": dict(family="mlp", hidden_dims=(16,), embed_dim=4, ensemble_size=2),
    "ft_transformer": dict(family="ft_transformer", token_dim=16, depth=1, heads=2),
    "bert": dict(family="bert", token_dim=16, depth=1, heads=2),
}
BASE = dict(precision="f32", dropout=0.0)


def model_configs(name: str):
    kw = {**FAMILIES[name], **BASE}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def hpo_configs(**kw):
    return JaxHPOConfig(**kw), HPOConfig(**kw)


def split(rows: int = 1500, seed: int = 3):
    """The JAX package's synthetic rows, encoded and split; the same
    arrays as the port's ``EncodedDataset``s."""
    columns, labels = jax_synthetic(rows, seed=seed)
    ds = JaxPreprocessor.fit(columns).encode(columns, labels)
    train, valid = jax_split(ds, 0.2)
    port = tuple(EncodedDataset(d.cat_ids, d.numeric, d.labels) for d in (train, valid))
    return (train, valid), port


def jax_seams(model_config, hpo_config, batch: int, n_rows: int, sha: bool) -> dict:
    """``{"init": [per-trial port params], "index_source": fn}`` of the
    JAX sweep for ``model_config`` and ``hpo_config``."""
    model = jax_build_model(model_config)
    keys = jax.random.split(jax.random.PRNGKey(hpo_config.seed), hpo_config.trials)
    dummy_cat = jnp.zeros((2, 9), jnp.int32)
    dummy_num = jnp.zeros((2, 14), jnp.float32)
    init, loops = [], []
    for key in keys:
        init_key, loop_key = (key, key) if sha else jax.random.split(key)
        params = model.init({"params": init_key}, dummy_cat, dummy_num, train=False)["params"]
        init.append(exact_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"))
        loops.append(loop_key)
    draw = jax.jit(
        lambda key, step: jax.random.randint(
            jax.random.split(jax.random.fold_in(key, step))[0], (batch,), 0, n_rows
        )
    )

    def index_source(trial_ids, step):
        return np.stack([np.asarray(draw(loops[i], step)) for i in trial_ids])

    return {"init": init, "index_source": index_source}


def group_seams(batch: int, n_rows: int, sha: bool = False):
    """``seams(g, cfg)`` for ``run_architecture_hpo``: group ``g`` of the
    JAX sweep is seeded ``seed + g``."""

    def seams(hpo_config):
        def for_group(g, cfg):
            jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
            jhpo = JaxHPOConfig(**{**dataclasses.asdict(hpo_config), "seed": hpo_config.seed + g})
            return jax_seams(jcfg, jhpo, batch, n_rows, sha)

        return for_group

    return seams
