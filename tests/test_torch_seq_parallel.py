"""The port's ring attention (``parallel/ring_attention.py``) and the
sequence-parallel doc trainer (``train/long_context.py`` on a ``('data',
'seq')`` mesh) against the JAX package's, on the CPU.

The port runs as one group of 4 gloo ranks (``tests/torch_dist.py``),
started once for this file; the JAX package runs in this process on
meshes of 2 and 4 of its 8 simulated devices. Tolerances:

- ring attention forward and the gradients of ``sum(out * g)`` at seq 2,
  seq 4 and data 2 x seq 2 (``[2, 16, 2, 8]`` f32 q, k, v): 2e-6 against
  the JAX ring and 2e-6 against dense attention (the same online softmax
  in f32, its chunks folded in another order than one softmax);
- the doc model (bert, doc_records 3: 140 tokens, which 2 and 4 divide;
  token_dim 16, depth 1, 2 heads, f32) trained three steps with the ring
  on seq 2, seq 4 and data 2 x seq 2 from the JAX init: step 1's loss
  1e-6 relative, the next 1e-5, the params within 1e-5 of each leaf's
  largest magnitude plus 1e-3 of Adam's travel (the key bias within the
  travel: ``test_torch_tensor_parallel.py``'s rule); its evaluation
  through the ring against the dense doc model on the same params 1e-5;
- ``train model.seq_parallel=true`` on 4 ranks: a ``doc`` bundle tagged
  ``long_context dp1xsp4`` that both packages load;
- the JAX package's refusal texts, exactly.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.parallel.mesh import make_nd_mesh as jax_make_nd_mesh
from mlops_tpu.parallel.ring_attention import make_ring_attention as jax_make_ring
from mlops_tpu.train.long_context import build_doc_model as jax_build_doc_model
from mlops_tpu.train.long_context import make_doc_train_step as jax_make_doc_train_step
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.long_context import build_doc_model
from mlops_tpu_torch.weights import doc_params_from_numpy, flatten_tree, load_params
from torch_dist import run_group

ATTN_TOL = 2e-6
LOSS_RTOL, CURVE_RTOL, PARAM_TOL, TRAVEL_FRAC, LOGIT_TOL = 1e-6, 1e-5, 1e-5, 1e-3, 1e-5
RING_MESHES = {"seq2": ({"seq": 2}, None), "seq4": ({"seq": 4}, None),
               "data2xseq2": ({"data": 2, "seq": 2}, "data")}
SP_MESHES = {"seq2": {"data": 1, "seq": 2}, "seq4": {"data": 1, "seq": 4},
             "data2xseq2": {"data": 2, "seq": 2}}
DOC = dict(family="bert", doc_records=3, token_dim=16, depth=1, heads=2, precision="f32",
           dropout=0.0)
DOC_TRAIN = dict(learning_rate=1e-2, weight_decay=1e-4)
SP_CLI = ["model.family=bert", "model.doc_records=3", "model.token_dim=16", "model.depth=1",
          "model.heads=2", "model.precision=f32", "model.seq_parallel=true", "data.rows=600",
          "train.batch_size=8", "train.steps=2", "train.eval_every=2", "train.device=cpu"]


def _attn_inputs():
    rng = np.random.default_rng(4)
    return {n: rng.normal(size=(2, 16, 2, 8)).astype(np.float32) for n in ("q", "k", "v", "g")}


def _docs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, (n, 3)) for c in SCHEMA.cards], axis=-1).astype(np.int32)
    num = rng.normal(size=(n, 3, SCHEMA.num_numeric)).astype(np.float32)
    return cat, num, (rng.random(n) < 0.4).astype(np.float32)


@pytest.fixture(scope="module")
def doc_init():
    trainer = jax_make_doc_train_step(JaxModelConfig(**DOC), JaxTrainConfig(**DOC_TRAIN), seed=0)
    return jax.tree_util.tree_map(np.asarray, trainer.params)


@pytest.fixture(scope="module")
def group(tmp_path_factory, doc_init):
    inputs = {
        **_attn_inputs(),
        "docs": _docs(4, 1), "vdocs": _docs(5, 2)[:2],
        "doc_model": DOC, "doc_train": {**DOC_TRAIN, "device": "cpu"},
        "doc_init": {k: v.numpy() for k, v in doc_params_from_numpy(doc_init, "cpu").items()},
        "sp_cli": SP_CLI,
    }
    return run_group(4, ["ring_attention", "sp_steps", "sp_train"], inputs,
                     tmp_path_factory.mktemp("sp_group"))


def _dense_attention(q, k, v):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("name", sorted(RING_MESHES))
def test_ring_attention_and_its_gradients_match_jax_and_dense(group, name):
    axes, batch = RING_MESHES[name]
    got = group["ring_attention"][name]
    a = {k: jnp.asarray(v) for k, v in _attn_inputs().items()}
    n = math.prod(axes.values())
    ring = jax_make_ring(jax_make_nd_mesh(axes, devices=jax.devices()[:n]), "seq",
                         batch_axis=batch)
    for fn in (ring, _dense_attention):
        out = fn(a["q"], a["k"], a["v"])
        grads = jax.grad(lambda q, k, v: (fn(q, k, v) * a["g"]).sum(), argnums=(0, 1, 2))(
            a["q"], a["k"], a["v"])
        np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0, atol=ATTN_TOL)
        for name_, grad in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name_], np.asarray(grad), rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("mesh", sorted(SP_MESHES))
def test_seq_parallel_doc_steps_match_the_jax_trainer(group, doc_init, mesh):
    got = group["sp_steps"][mesh]
    axes = SP_MESHES[mesh]
    n = math.prod(axes.values())
    trainer = jax_make_doc_train_step(
        JaxModelConfig(**DOC, seq_parallel=True), JaxTrainConfig(**DOC_TRAIN),
        mesh=jax_make_nd_mesh(axes, devices=jax.devices()[:n]), seed=0)
    params, opt, ema, losses = doc_init, trainer.opt_state, trainer.ema, []
    cat, num, lab = _docs(4, 1)
    for _ in range(3):
        params, opt, ema, loss = trainer.step_fn(params, opt, ema, cat, num, lab)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], losses, rtol=CURVE_RTOL)
    travel = 3 * DOC_TRAIN["learning_rate"] * 0.1 / math.sqrt(1 - 0.999) / (1 - 0.9)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    assert set(got["params"]) == set(want)
    for k, w in want.items():
        err = np.abs(got["params"][k] - w)
        key = np.zeros(err.shape, bool)
        if k.endswith("qkv.bias"):
            key[1] = True
        assert err[~key].max(initial=0.0) <= PARAM_TOL * np.abs(w).max() + TRAVEL_FRAC * travel, k
        assert err[key].max(initial=0.0) <= travel, k
    # The ring's evaluation (data blocks padded and gathered) is the dense
    # doc model's on the same params.
    dense = load_params(build_doc_model(ModelConfig(**DOC)),
                        {k: torch.from_numpy(v) for k, v in got["params"].items()})
    vcat, vnum, _ = _docs(5, 2)
    with torch.no_grad():
        want_logits = dense(torch.from_numpy(vcat), torch.from_numpy(vnum)).numpy()
    np.testing.assert_allclose(got["logits"], want_logits, rtol=0, atol=LOGIT_TOL)


def test_train_seq_parallel_on_four_ranks_writes_a_doc_bundle(group):
    got = group["sp_train"]
    bundle = Path(got["bundle"])
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["flavor"] == "doc"
    assert manifest["tags"]["trained_with"] == "long_context dp1xsp4"
    assert [r["step"] for r in got["history"]] == [2]
    assert math.isfinite(got["history"][0]["loss"])
    assert jax_load_bundle(bundle).flavor == "doc"
    model = load_bundle(bundle).model
    cat, num, _ = _docs(3, 9)
    with torch.no_grad():
        assert torch.isfinite(model(torch.from_numpy(cat), torch.from_numpy(num))).all()


def test_the_seq_parallel_refusals_are_the_jax_texts(tmp_path):
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    with pytest.raises(ValueError) as want:
        jax_build_doc_model(JaxModelConfig(**DOC, seq_parallel=True))
    with pytest.raises(ValueError) as got:
        build_doc_model(ModelConfig(**DOC, seq_parallel=True))
    assert str(got.value) == str(want.value)
    # One rank: no divisor of the world size above 1 divides the
    # document, the JAX package's sentence with the world size.
    with pytest.raises(ValueError) as one:
        run_layout_training(load_config([*SP_CLI, f"registry.run_root={tmp_path}"]))
    assert str(one.value) == (
        "seq_parallel needs the document length (2 + 46*doc_records = 140) to share a "
        "factor with the device count 1; pick doc_records accordingly (11 -> 508 works "
        "on 2/4-way)")
