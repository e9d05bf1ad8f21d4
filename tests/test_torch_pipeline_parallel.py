"""The port's GPipe (``parallel/pipeline.py``) and pipeline-parallel
trainer (``train/pipeline_parallel.py``) against the JAX package's, on
the CPU.

The port runs as one group of 4 gloo ranks (``tests/torch_dist.py``),
started once for this file; the JAX package runs in this process on
meshes of 2 and 4 of its 8 simulated devices. Tolerances:

- GPipe forward and the gradients of ``sum(y * g)`` (weights, input) at
  S = 2, 4 and data 2 x stage 2, a ``tanh(h @ W + b)`` stage in f32:
  2e-6 (the same f32 products; the stages' gradients summed over the
  microbatches in another order);
- the PP trainer at S = 2 and data 2 x stage 2 (bert and ft_transformer,
  token_dim 16, depth 2, 2 heads, f32, dropout 0, 4 microbatches) from
  the JAX stage layout (``weights.pp_params_from_numpy``): step 1's loss
  1e-6 relative and merged gradients within 1e-5 of each leaf's largest
  magnitude against the dense JAX gradients (the forward is the dense
  model's), three steps' losses 1e-5 and the merged params against the
  JAX trainer's as ``test_torch_tensor_parallel.py`` holds them (1e-5 of
  the leaf's magnitude plus 1e-3 of Adam's travel, the key bias within
  the travel);
- the stage layout, split and merged: bitwise the JAX package's;
- ``train model.pipeline_stages=2`` on 4 ranks (dp 2 x pp 2): the merged
  bundle served by both packages' engines, predictions 1e-5 (f32);
- rematerialized stages: the same losses bit for bit;
- the JAX package's refusal texts, exactly.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.parallel.mesh import make_nd_mesh as jax_make_nd_mesh
from mlops_tpu.parallel.pipeline import make_pipeline as jax_make_pipeline
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train.loop import training_loss as jax_training_loss
from mlops_tpu.train.pipeline_parallel import make_pp_train_step as jax_make_pp_train_step
from mlops_tpu.train.pipeline_parallel import merge_trunk_params as jax_merge
from mlops_tpu.train.pipeline_parallel import split_trunk_params as jax_split
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import ModelConfig, TrainConfig
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.train.pipeline_parallel import (
    PipelineModel,
    make_pp_train_step,
    merge_trunk_params,
    pp_tree,
    split_trunk_params,
)
from mlops_tpu_torch.weights import exact_params_from_numpy, flatten_tree, pp_params_from_numpy
from torch_dist import run_group
from torch_ring import records

PIPE_TOL = 2e-6
LOSS_RTOL, CURVE_RTOL, GRAD_TOL, PARAM_TOL, TRAVEL_FRAC = 1e-6, 1e-5, 1e-5, 1e-5, 1e-3
PRED_TOL = 1e-5
M, B, D = 4, 4, 8
PIPE_MESHES = {"stage2": ({"stage": 2}, None), "stage4": ({"stage": 4}, None),
               "data2xstage2": ({"data": 2, "stage": 2}, "data")}
MODELS = {f: dict(family=f, token_dim=16, depth=2, heads=2, precision="f32", dropout=0.0)
          for f in ("bert", "ft_transformer")}
TRAIN = dict(batch_size=16, steps=100, warmup_steps=2, learning_rate=1e-2, pos_weight=3.0,
             pipeline_microbatches=4)
PP_MESHES = {"stage2": {"data": 1, "stage": 2}, "data2xstage2": {"data": 2, "stage": 2}}
PP_CLI = ["model.family=bert", "model.token_dim=16", "model.depth=2", "model.heads=2",
          "model.dropout=0", "model.precision=f32", "model.pipeline_stages=2",
          "data.rows=1500", "train.batch_size=32", "train.pipeline_microbatches=4",
          "train.steps=4", "train.eval_every=2", "train.device=cpu",
          "train.distill_bulk=false"]


def _pipe_inputs():
    rng = np.random.default_rng(3)
    return {"W": (rng.normal(size=(4, D, D)) / math.sqrt(D)).astype(np.float32),
            "b": (0.1 * rng.normal(size=(4, D))).astype(np.float32),
            "x": rng.normal(size=(M, B, D)).astype(np.float32),
            "g": rng.normal(size=(M, B, D)).astype(np.float32)}


def _batch(rows: int, seed: int):
    from mlops_tpu_torch.schema.features import SCHEMA

    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, rows) for c in SCHEMA.cards], axis=1).astype(np.int32)
    num = rng.normal(size=(rows, SCHEMA.num_numeric)).astype(np.float32)
    return cat, num, (rng.random(rows) < 0.3).astype(np.float32)


def _dense_init(family: str) -> dict:
    model = jax_build_model(JaxModelConfig(**MODELS[family]))
    return jax.tree_util.tree_map(np.asarray, jax_init_params(model, jax.random.PRNGKey(0))["params"])


@pytest.fixture(scope="module")
def inits():
    return {f: _dense_init(f) for f in MODELS}


@pytest.fixture(scope="module")
def group(tmp_path_factory, inits):
    pipe = _pipe_inputs()
    inputs = {
        **pipe,
        "pp_models": MODELS, "pp_train": {**TRAIN, "device": "cpu"},
        "pp_layout": {f: {k: v.numpy() for k, v in pp_params_from_numpy(
            jax_split(tree, 2, f), "cpu").items()} for f, tree in inits.items()},
        "pp_batch": _batch(TRAIN["batch_size"], 5),
        "pp_cli": PP_CLI,
    }
    return run_group(4, ["gpipe", "pp_steps", "pp_train"], inputs,
                     tmp_path_factory.mktemp("pp_group"))


def _jax_stage(w, h):
    return jnp.tanh(h @ w["W"] + w["b"])


@pytest.mark.parametrize("name", sorted(PIPE_MESHES))
def test_gpipe_forward_and_gradients_match_the_jax_pipeline(group, name):
    axes, batch = PIPE_MESHES[name]
    got = group["gpipe"][name]
    p = _pipe_inputs()
    stages = axes["stage"]
    n = math.prod(axes.values())
    run = jax_make_pipeline(jax_make_nd_mesh(axes, devices=jax.devices()[:n]), _jax_stage,
                            batch_axis=batch)
    w = {"W": jnp.asarray(p["W"][:stages]), "b": jnp.asarray(p["b"][:stages])}
    x, g = jnp.asarray(p["x"]), jnp.asarray(p["g"])
    y = run(w, x)
    (dw, dx) = jax.grad(lambda w_, x_: (run(w_, x_) * g).sum(), argnums=(0, 1))(w, x)
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=0, atol=PIPE_TOL)
    np.testing.assert_allclose(got["dx"], np.asarray(dx), rtol=0, atol=PIPE_TOL)
    np.testing.assert_allclose(got["dW"], np.asarray(dw["W"]), rtol=0, atol=PIPE_TOL)
    np.testing.assert_allclose(got["db"], np.asarray(dw["b"]), rtol=0, atol=PIPE_TOL)
    # ... and the pipeline is the stages folded in order.
    fold = x
    for s in range(stages):
        fold = jnp.tanh(fold @ w["W"][s] + w["b"][s])
    np.testing.assert_allclose(got["y"], np.asarray(fold), rtol=0, atol=PIPE_TOL)


def _adam_travel(steps: int) -> float:
    from mlops_tpu_torch.train.loop import lr_schedule

    schedule = lr_schedule(TrainConfig(**TRAIN))
    return sum(schedule(t) for t in range(steps)) * 0.1 / math.sqrt(1 - 0.999)


@pytest.mark.parametrize("mesh", sorted(PP_MESHES))
@pytest.mark.parametrize("family", sorted(MODELS))
def test_the_pp_trainer_matches_the_jax_trainer(group, inits, family, mesh):
    got = group["pp_steps"][(family, mesh)]
    axes = PP_MESHES[mesh]
    cat, num, lab = _batch(TRAIN["batch_size"], 5)
    dense = jax_build_model(JaxModelConfig(**MODELS[family]))
    loss, grads = jax.value_and_grad(
        lambda p: jax_training_loss(dense, p, cat, num, lab, jax.random.PRNGKey(0),
                                    TRAIN["pos_weight"]))(inits[family])
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=LOSS_RTOL)
    for k, w in flatten_tree(jax.tree_util.tree_map(np.asarray, grads)).items():
        assert np.abs(got["grads"][k] - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-12), k
    n = math.prod(axes.values())
    trainer = jax_make_pp_train_step(
        JaxModelConfig(**MODELS[family], pipeline_stages=axes["stage"]),
        JaxTrainConfig(**TRAIN), jax_make_nd_mesh(axes, devices=jax.devices()[:n]),
        init_variables={"params": inits[family]})
    params, opt, ema, losses = trainer.params, trainer.opt_state, trainer.ema, []
    for _ in range(3):
        params, opt, ema, loss = trainer.step_fn(params, opt, ema, cat, num, lab)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=CURVE_RTOL)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_merge(jax.device_get(params))))
    travel = _adam_travel(3)
    assert set(got["params"]) == set(want)
    for k, w in want.items():
        err = np.abs(got["params"][k] - w)
        key = np.zeros(err.shape, bool)
        if k.endswith("qkv.bias"):
            key[1] = True
        assert err[~key].max(initial=0.0) <= PARAM_TOL * np.abs(w).max() + TRAVEL_FRAC * travel, k
        assert err[key].max(initial=0.0) <= travel, k


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_the_stage_layout_is_the_jax_layout(inits, family, stages):
    """``split_trunk_params`` / ``merge_trunk_params`` of both packages on
    one tree, and the JAX layout carried across by name: the same arrays
    under the ``PipelineModel``'s names."""
    tree = inits[family]
    port_dense = {k: torch.from_numpy(v.numpy()) for k, v in
                  exact_params_from_numpy(tree, "cpu").items()}
    want = pp_params_from_numpy(jax_split(tree, stages, family), "cpu")
    got = flatten_tree(split_trunk_params(port_dense, stages, family))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), v), k
    merged = merge_trunk_params(pp_tree(want))
    for k, v in port_dense.items():
        assert torch.equal(merged[k], v), k
    back = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_merge(jax_split(tree, stages, family))))
    assert set(back) == set(port_dense)
    mesh = types.SimpleNamespace(size=lambda axis: stages if axis == "stage" else 1)
    model = PipelineModel(ModelConfig(**MODELS[family], pipeline_stages=stages), mesh, 4)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: (1, *v.shape[1:]) if k.startswith("stages.") else tuple(v.shape)
        for k, v in want.items()}


def test_train_pipeline_stages_2_on_four_ranks_serves_its_merged_bundle(group):
    import json
    from pathlib import Path

    got = group["pp_train"]
    bundle = Path(got["bundle"])
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["flavor"] == "flax"
    assert manifest["tags"]["trained_with"] == "pipeline_parallel dp2xpp2"
    assert got["model_uri"] == "models:/credit-default-uci-custom/1"
    assert [r["step"] for r in got["history"]] == [2, 4]
    body = records(24, seed=2)
    want = JaxEngine(jax_load_bundle(bundle)).predict_records(body)
    port = InferenceEngine(load_bundle(bundle), device="cpu").predict_records(body)
    np.testing.assert_allclose(port["predictions"], want["predictions"], rtol=0, atol=PRED_TOL)


def test_rematerialized_stages_change_nothing():
    from mlops_tpu_torch.parallel.distributed import initialize
    from mlops_tpu_torch.parallel.mesh import make_nd_mesh

    initialize("cpu")
    mesh = make_nd_mesh({"data": 1, "stage": 1})
    cat, num, lab = (torch.from_numpy(a) for a in _batch(TRAIN["batch_size"], 5))
    runs = []
    for remat in (False, True):
        trainer = make_pp_train_step(ModelConfig(**MODELS["bert"], pipeline_stages=1),
                                     TrainConfig(**TRAIN, pipeline_remat=remat), mesh)
        runs.append([trainer.step(s, cat, num, lab) for s in (1, 2)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------- refusals
def _both(base_family="bert", **kw):
    base = {**MODELS[base_family], **kw}
    return JaxModelConfig(**base), ModelConfig(**base)


def _same(jax_call, port_call, prefix: str = ""):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    if prefix:
        assert str(want.value).startswith(prefix) and str(got.value).startswith(prefix)
    else:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    "family", "ensemble", "no_stage_axis", "stages_mismatch", "depth", "dropout", "microbatches",
])
def test_the_pp_refusals_are_the_jax_texts(case):
    mesh_axes = {"data": 2, "stage": 2}
    model_kw, train_kw = {}, {}
    family = "bert"
    if case == "family":
        family = "ft_transformer"
        model_kw = dict(family="mlp")
    elif case == "ensemble":
        model_kw = dict(ensemble_size=2)
    elif case == "no_stage_axis":
        mesh_axes = {"data": 4}
    elif case == "stages_mismatch":
        model_kw = dict(pipeline_stages=4)
    elif case == "depth":
        model_kw = dict(depth=3)
    elif case == "dropout":
        model_kw = dict(dropout=0.1)
    else:
        train_kw = dict(batch_size=18)
    jm, pm = _both(family, **model_kw)
    jt, pt = JaxTrainConfig(**{**TRAIN, **train_kw}), TrainConfig(**{**TRAIN, **train_kw})
    jmesh = jax_make_nd_mesh(mesh_axes, devices=jax.devices()[:4])
    pmesh = types.SimpleNamespace(axis_names=tuple(mesh_axes), shape=dict(mesh_axes))
    _same(lambda: jax_make_pp_train_step(jm, jt, jmesh), lambda: make_pp_train_step(pm, pt, pmesh))


def test_the_layout_refusals_of_train_are_the_jax_texts(tmp_path):
    import mlops_tpu.train.pipeline as jax_pipeline
    from mlops_tpu.config import load_config as jax_load_config
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    def both(args, prefix=""):
        args = [*args, f"registry.run_root={tmp_path}", "data.rows=200"]
        _same(lambda: jax_pipeline.run_layout_training(jax_load_config(overrides=args, env={})),
              lambda: run_layout_training(load_config([*args, "train.device=cpu"])), prefix)

    both(["model.family=bert", "model.pipeline_stages=3", "model.dropout=0"],
         prefix="model.pipeline_stages=3 needs the device count to be a multiple of it")
    both(["model.family=bert", "model.doc_records=3", "train.init_params=x.msgpack"])
    both(["model.family=ft_transformer", "model.pipeline_stages=2",
          "train.init_params=x.msgpack"])
