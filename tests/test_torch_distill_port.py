"""Bundles the port's ``run_training`` distills, against the JAX package,
on the CPU (split from ``test_torch_distill.py``, whose fixture trains the
JAX side: the parallel run then spreads the two trainings).

Bundles cross: a port-written bundle with both students is read by the
JAX ``load_bundle`` and scored by the JAX ``score_dataset`` on the
distilled and quant paths within the bulk tolerances
(``test_torch_bulk.py``); ``run_training`` writes the ``bulk`` block for
an ensemble and a small FT-Transformer at the default ``distill_bulk``;
the refusals stay: gbm in ``tune``, and a ``train.init_params`` that
cannot graft (a moe model, a missing file) with the JAX package's
errors.
"""

import json

import jax
import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.data.encode import EncodedDataset as JaxEncodedDataset
from mlops_tpu.parallel import bulk as jbulk
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import load_config
from mlops_tpu_torch.data import generate_synthetic
from mlops_tpu_torch.parallel import bulk
from mlops_tpu_torch.train.pipeline import run_training, run_tuning
from torch_students import DRIFT_ATOL, PRED_TOL, assert_flags_match
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)


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
        # moe trains now (A9); a pretrained trunk cannot graft into it,
        # refused with the JAX package's message before any work.
        pytest.param(["model.family=moe", "train.init_params={tmp}/pretrained.msgpack"],
                     "shares no trunk", id="overrides0-A9"),
        # gbm trains now; `tune` still refuses it, with the JAX message.
        pytest.param(["model.family=gbm"], "sklearn baseline families", id="overrides1-A8"),
        # train.init_params is ported (A9): a missing file is reported as
        # the JAX package reports it, before any work.
        pytest.param(["model.family=bert", "model.token_dim=16", "model.depth=1",
                      "model.heads=2", "train.init_params={tmp}/missing.msgpack"],
                     "No such file or directory", id="overrides2-A9"),
    ],
)
def test_the_other_refusals_stay(tmp_path, overrides, match):
    overrides = [o.format(tmp=tmp_path) for o in overrides]
    config = load_config(["train.device=cpu", f"registry.run_root={tmp_path / 'runs'}",
                          *overrides])
    run = run_tuning if config.model.family == "gbm" else run_training
    error = FileNotFoundError if "missing" in config.train.init_params else ValueError
    with pytest.raises(error, match=match) as got:
        run(config)
    assert not (tmp_path / "runs").exists()
    if config.train.init_params:
        from mlops_tpu.config import load_config as jax_load_config
        from mlops_tpu.models import build_model as jax_build_model
        from mlops_tpu.models import init_params as jax_init_params
        from mlops_tpu.train.pretrain import load_pretrained_variables

        jcfg = jax_load_config(None, overrides)
        jmodel = jax_build_model(jcfg.model)
        fresh = jax.jit(lambda key: jax_init_params(jmodel, key))(jax.random.PRNGKey(0))
        with pytest.raises(error) as want:
            load_pretrained_variables(jcfg.train.init_params, jcfg.model, fresh)
        assert str(got.value) == str(want.value)


def test_score_and_lifecycle_tables_load():
    config = load_config(["score.chunk_rows=4096", "score.streaming=true",
                          "lifecycle.max_ece=0.2"])
    assert config.score.chunk_rows == 4096 and config.score.streaming is True
    assert config.lifecycle.max_ece == 0.2
