"""The port's DP x TP training (``parallel/steps.py``,
``train/tensor_parallel.py``) against the JAX package's
``make_tp_trainer`` on matching meshes, on the CPU.

The port runs as one group of 4 gloo ranks (``tests/torch_dist.py``),
started once for this file; the JAX package runs in this process on
meshes of 2 and 4 of its 8 simulated devices, from the same flax init
(carried by ``weights.py``) on the same numpy batch. Tiny f32 models,
dropout 0 against JAX: mlp (16, 16) embed 4, ft_transformer, bert and moe
(4 experts) at token_dim 16, depth 1, 4 heads. Tolerances, the dense
trainer's (``test_torch_exact_train.py``):

- step 1's loss 1e-6 relative, each gradient leaf within 1e-5 of its
  largest magnitude (the same f32 arithmetic in another order, the row-
  split partial sums added over the ranks);
- the next steps' losses 1e-5 relative and the params after three steps
  within 1e-5 of each leaf's largest magnitude plus 1e-3 of Adam's
  largest travel ``sum_t lr_t * (1 - b1) / sqrt(1 - b2)``: Adam divides
  each element's moment by its own root mean square, so an element with a
  small gradient moves by its gradient's relative error times the step
  (measured worst 3.7e-4 of the travel, the moe's attention kernel on 4
  ranks; the JAX package's own moe on a 1x2 and a 1x4 mesh is 6.7e-5 of
  it apart), except the attention key bias,
  whose gradient is zero analytically: Adam turns its float noise into
  steps of up to the learning rate, so that slice is held within the
  whole travel (``test_torch_hpo.py``'s rule);
- K ranks against one with dropout on (0.1, the port's own streams on
  both sides): the same tolerances;
- the global-norm clip over a split leaf against ``optax``'s on the
  logical array: 1e-6;
- a TP and a PP run resumed from their checkpoints: bit for bit a
  straight run (one rank, the CPU);
- ``train model.tensor_parallel=2`` under the launcher on 2 ranks against
  1 rank: the journal's losses 1e-5 relative, the bundle's params 1e-5 of
  each leaf's largest magnitude.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.parallel.mesh import make_nd_mesh as jax_make_nd_mesh
from mlops_tpu.train.loop import training_loss as jax_training_loss
from mlops_tpu.train.tensor_parallel import make_tp_trainer as jax_make_tp_trainer
from mlops_tpu_torch.config import Config, ModelConfig, TrainConfig
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.tensor_parallel import TP_FAMILIES, make_tp_trainer
from mlops_tpu_torch.weights import exact_params_from_numpy, flatten_tree
from torch_dist import DEADLINE_S, run_group

ROOT = Path(__file__).resolve().parent.parent
MODELS = {
    "mlp": dict(family="mlp", hidden_dims=(16, 16), embed_dim=4),
    "ft_transformer": dict(family="ft_transformer", token_dim=16, depth=1, heads=4),
    "bert": dict(family="bert", token_dim=16, depth=1, heads=4),
    "moe": dict(family="moe", token_dim=16, depth=1, heads=4, num_experts=4),
}
BASE = dict(precision="f32", dropout=0.0)
TRAIN = dict(batch_size=16, steps=100, warmup_steps=2, learning_rate=1e-2, pos_weight=3.0)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
LOSS_RTOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-5
TRAVEL_FRAC = 1e-3
CURVE_RTOL = 1e-5  # losses after updates: the params' tolerance


def _batch(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, rows) for c in SCHEMA.cards], axis=1).astype(np.int32)
    num = rng.normal(size=(rows, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(rows) < 0.3).astype(np.float32)
    return cat, num, lab


def _jax_init(family: str) -> dict:
    model = jax_build_model(JaxModelConfig(**MODELS[family], **BASE))
    return jax.tree_util.tree_map(np.asarray, jax_init_params(model, jax.random.PRNGKey(0))["params"])


def _port(tree) -> dict:
    return {k: v.numpy() for k, v in exact_params_from_numpy(tree, "cpu").items()}


@pytest.fixture(scope="module")
def inits():
    return {family: _jax_init(family) for family in MODELS}


@pytest.fixture(scope="module")
def group(tmp_path_factory, inits):
    inputs = {
        "families": list(MODELS),
        "models": {f: {**kw, **BASE} for f, kw in MODELS.items()},
        "train": {**TRAIN, "device": "cpu"},
        "init": {f: _port(tree) for f, tree in inits.items()},
        "batch": _batch(TRAIN["batch_size"], 7),
        "clip_split": np.asarray([0.8, 0.0, 0.0, 0.8], np.float32),
        "clip_rep": np.zeros(2, np.float32),
    }
    return run_group(4, ["tp_steps", "tp_dropout", "tp_clip"], inputs,
                     tmp_path_factory.mktemp("tp_group"))


def _key_bias_mask(name: str, shape) -> np.ndarray:
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        mask[1] = True
    return mask


def _adam_travel(steps: int) -> float:
    """Adam's largest move over ``steps`` steps of the warmup-cosine
    schedule: ``sum_t lr_t * (1 - b1) / sqrt(1 - b2)``."""
    from mlops_tpu_torch.train.loop import lr_schedule

    schedule = lr_schedule(TrainConfig(**TRAIN))
    return sum(schedule(t) for t in range(steps)) * 0.1 / math.sqrt(1 - 0.999)


def _assert_params(got: dict, want: dict, steps: int = 3):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(got[k]) - w)
        mask = _key_bias_mask(k, err.shape)
        tol = PARAM_TOL * np.abs(w).max() + TRAVEL_FRAC * _adam_travel(steps)
        assert err[~mask].max(initial=0.0) <= tol, (k, err[~mask].max() / _adam_travel(steps))
        assert err[mask].max(initial=0.0) <= _adam_travel(steps), k


def _jax_run(family: str, dp: int, tp: int, init: dict, batch, steps: int = 3):
    config = JaxConfig()
    config.model = JaxModelConfig(**MODELS[family], **BASE, tensor_parallel=tp)
    config.train = JaxTrainConfig(**TRAIN)
    mesh = jax_make_nd_mesh({"data": dp, "model": tp}, devices=jax.devices()[: dp * tp])
    trainer = jax_make_tp_trainer(config, mesh=mesh, init_variables={"params": init})
    state, losses = trainer.state, []
    for _ in range(steps):
        state, loss = trainer.step_fn(state, *batch, jax.random.PRNGKey(1))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(MODELS))
def test_dp_tp_steps_match_the_jax_trainer(group, inits, family, mesh):
    got = group["tp_steps"][(family, mesh)]
    dp, tp = MESHES[mesh]
    batch = _batch(TRAIN["batch_size"], 7)
    model = jax_build_model(JaxModelConfig(**MODELS[family], **BASE))
    loss, grads = jax.value_and_grad(
        lambda p: jax_training_loss(model, p, *batch, jax.random.PRNGKey(1), TRAIN["pos_weight"])
    )(inits[family])
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=LOSS_RTOL)
    for k, w in flatten_tree(jax.tree_util.tree_map(np.asarray, grads)).items():
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(got["grads"][k] - w).max() <= GRAD_TOL * scale, k
    losses, params = _jax_run(family, dp, tp, inits[family], batch)
    np.testing.assert_allclose(got["losses"], losses, rtol=CURVE_RTOL)
    _assert_params(got["params"], flatten_tree(params))


@pytest.mark.parametrize("family", sorted(MODELS))
def test_k_ranks_compute_what_one_rank_computes_with_dropout_on(group, family):
    one, four = group["tp_dropout"][(family, "1x1")], group["tp_dropout"][(family, "2x2")]
    np.testing.assert_allclose(four["losses"][0], one["losses"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=CURVE_RTOL)
    for k, w in one["grads"].items():
        assert np.abs(four["grads"][k] - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-12), k
    _assert_params(four["params"], one["params"])
    # Dropout ran: the masked step is not the unmasked one.
    assert not np.isclose(one["losses"][0], group["tp_steps"][(family, "1x2")]["losses"][0],
                          rtol=1e-4)


def test_the_clip_counts_every_block_of_a_split_leaf(group):
    """Each rank's block of the split leaf has norm 0.8: the logical
    gradient's norm, 1.13, crosses 1 only with both blocks counted."""
    got = group["tp_clip"]
    assert got["local_norm_rank0"] < 1.0
    tree = {"split": np.asarray([0.8, 0.0, 0.0, 0.8], np.float32), "rep": np.zeros(2, np.float32)}
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update(tree, clip.init(tree))
    np.testing.assert_allclose(got["split"], want["split"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["rep"], want["rep"], rtol=0, atol=1e-6)
    assert not np.allclose(got["split"], tree["split"])


def _launch(nproc: int, root: Path, tp: int | None) -> dict:
    """``train`` of a tiny mlp under the launcher on ``nproc`` gloo ranks,
    with ``model.tensor_parallel=tp`` (the dense trainer when None)."""
    layout = [] if tp is None else [f"model.tensor_parallel={tp}"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "mlops_tpu_torch", "train",
           "--config", "configs/train_register_job.toml", "train.device=cpu",
           *layout, "model.precision=f32", "model.hidden_dims=16,16",
           "model.embed_dim=4", "data.rows=2000", "train.batch_size=64", "train.steps=6",
           "train.eval_every=3", f"registry.root={root / 'reg'}",
           f"registry.run_root={root / 'runs'}", "registry.run_name=tp"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [obj for line in out.stdout.splitlines() if line.startswith("{")
             for obj in _objects(line)]
    assert len(lines) == nproc and all(line == lines[0] for line in lines)
    return lines[0]


def _objects(line: str) -> list:
    """The JSON objects printed on one stdout line: the ranks share the
    pipe, and two ranks' results printed at once can land on one line."""
    decoder, out, i = json.JSONDecoder(), [], 0
    line = line.rstrip()
    while i < len(line):
        obj, i = decoder.raw_decode(line, i)
        out.append(obj)
    return out


def test_train_tensor_parallel_2_under_the_launcher_equals_one_rank(tmp_path):
    from mlops_tpu_torch.bundle import load_bundle

    two = _launch(2, tmp_path / "two", 2)
    one = _launch(1, tmp_path / "one", 1)

    def journal(out):
        return [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]

    j2, j1 = journal(two), journal(one)
    assert [r["step"] for r in j2] == [r["step"] for r in j1] == [3, 6]
    np.testing.assert_allclose([r["loss"] for r in j2], [r["loss"] for r in j1], rtol=1e-5)
    manifests = [json.loads((Path(o["bundle"]) / "manifest.json").read_text()) for o in (two, one)]
    assert [m["tags"]["trained_with"] for m in manifests] == [
        "tensor_parallel dp1xtp2", "tensor_parallel dp1xtp1"]
    p2, p1 = (load_bundle(o["bundle"]).model.state_dict() for o in (two, one))
    for k, w in p1.items():
        assert (p2[k] - w).abs().max().item() <= PARAM_TOL * max(w.abs().max().item(), 1e-12), k


def test_dense_train_under_the_launcher_writes_once_and_equals_one_rank(tmp_path):
    """Both ranks train the job's dense mlp; the coordinator alone writes
    the run directory's journal and checkpoints, the bundle and one
    registry version, and every rank prints its result."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.bundle.registry import ModelRegistry

    two = _launch(2, tmp_path / "two", None)
    one = _launch(1, tmp_path / "one", None)
    assert two["metrics"] == one["metrics"] and two["steps"] == one["steps"] == 6

    def journal(out):
        return [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]

    j2, j1 = journal(two), journal(one)
    assert [r["step"] for r in j2] == [r["step"] for r in j1] == [3, 6]
    assert [r["train_loss"] for r in j2] == [r["train_loss"] for r in j1]
    assert two["model_uri"].endswith("/1")
    versions = ModelRegistry(tmp_path / "two" / "reg").list_versions(
        "credit-default-uci-custom")
    assert [v["version"] for v in versions] == [1]
    p2, p1 = (load_bundle(o["bundle"]).model.state_dict() for o in (two, one))
    for k, w in p1.items():
        assert torch.equal(p2[k], w), k


# ---------------------------------------------------------------- refusals
def _configs(family="mlp", tp=2, batch=16):
    jc, pc = JaxConfig(), Config()
    jc.model = JaxModelConfig(family=family, tensor_parallel=tp)
    pc.model = ModelConfig(family=family, tensor_parallel=tp)
    jc.train = JaxTrainConfig(batch_size=batch)
    pc.train = TrainConfig(batch_size=batch, device="cpu")
    return jc, pc


def _same_refusal(jax_call, port_call, prefix: str = ""):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    w, g = str(want.value), str(got.value)
    if prefix:
        assert w.startswith(prefix) and g.startswith(prefix), (w, g)
    else:
        assert g == w
    return g


def test_the_tp_refusals_are_the_jax_texts():
    jc, pc = _configs(family="gbm")
    _same_refusal(lambda: jax_make_tp_trainer(jc), lambda: make_tp_trainer(pc))
    assert TP_FAMILIES == ("mlp", "linear", "ft_transformer", "bert", "moe")
    # The world (the port) and the device count (JAX) not a multiple of K:
    # the same sentence up to the advice on how to launch.
    jc, pc = _configs(tp=3)
    _same_refusal(lambda: jax_make_tp_trainer(jc), lambda: make_tp_trainer(pc),
                  prefix="model.tensor_parallel=3 needs the device count to be a multiple of it")
    jc, pc = _configs(tp=2)
    jmesh = jax_make_nd_mesh({"data": 4, "model": 1}, devices=jax.devices()[:4])
    pmesh = types.SimpleNamespace(shape={"data": 4, "model": 1})
    _same_refusal(lambda: jax_make_tp_trainer(jc, mesh=jmesh),
                  lambda: make_tp_trainer(pc, mesh=pmesh))
    jc, pc = _configs(tp=2, batch=15)
    jmesh = jax_make_nd_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    pmesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    _same_refusal(lambda: jax_make_tp_trainer(jc, mesh=jmesh),
                  lambda: make_tp_trainer(pc, mesh=pmesh))


def test_one_rank_takes_a_one_way_model_axis_where_jax_asks_for_two():
    """The one deliberate difference: ``tensor_parallel=1`` is the only TP
    layout one card holds (the card's bit-for-bit check runs it)."""
    jc, pc = _configs(tp=1)
    with pytest.raises(ValueError, match="needs model.tensor_parallel >= 2"):
        jax_make_tp_trainer(jc)
    pc.model = dataclasses.replace(pc.model, hidden_dims=(8, 8))
    trainer = make_tp_trainer(pc)
    assert trainer.mesh.shape == {"data": 1, "model": 1}
    pc.model = dataclasses.replace(pc.model, tensor_parallel=0)
    with pytest.raises(ValueError, match="needs model.tensor_parallel >= 1"):
        make_tp_trainer(pc)


@pytest.mark.parametrize("layout", ["model.tensor_parallel=1", "model.pipeline_stages=1"])
def test_a_layout_run_resumes_from_its_checkpoint_bit_for_bit(tmp_path, layout):
    """Two steps, then the same run asked for four: it restores the whole
    state (params, Adam's moments and count, the EMA) onto the layout and
    ends where a straight four-step run ends."""
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    base = ["model.family=bert", "model.token_dim=16", "model.depth=2", "model.heads=2",
            "model.dropout=0", "model.precision=f32", layout, "data.rows=600",
            "train.batch_size=16", "train.pipeline_microbatches=2", "train.eval_every=2",
            "train.checkpoint_every=2", "train.ema_decay=0.9", "train.distill_bulk=false",
            "train.device=cpu"]

    def run(name, steps):
        config = load_config([*base, f"train.steps={steps}", f"registry.root={tmp_path / name}",
                              f"registry.run_root={tmp_path / name / 'runs'}"])
        return run_layout_training(config, run_name="r")

    run("resumed", 2)
    resumed = run("resumed", 4)
    straight = run("straight", 4)
    for k, v in straight.train_result.params.items():
        assert torch.equal(resumed.train_result.params[k], v), k
    rows = [json.loads(line) for line in (resumed.run_dir / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [2, 4]
