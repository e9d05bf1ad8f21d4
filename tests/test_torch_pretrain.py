"""Masked-feature pretraining (``mlops_tpu_torch/train/pretrain.py``,
``models/bert.py::BertMaskedLM``) and the ``train.init_params`` graft
against the JAX package's, on the CPU.

A small masked-LM (hidden 16, depth 2, 4 heads, vocabulary 559, 48
tokens), weights from the flax ``init`` plus seeded numpy noise, carried
across by ``exact_params_from_numpy``; rows made by numpy from a seed or
by the JAX package's synthetic data. Tolerances:

- MLM logits against the flax apply at one shared mask: f32 1e-5 of the
  logits' scale. bf16: measured in four bf16 ulps at the logit's
  magnitude (at least 1, the exact tier's logit tolerance) from the
  eager or the jitted apply, whichever is nearer, the port is no farther
  than JAX's two evaluations are from each other: its worst logit within
  their largest gap, and no larger a share of logits past four ulps. Over
  the 644,000 logits of 24 rows, the eager and jitted applies differ by
  up to 17 ulps, on 0.8-3 % of logits, and the port by up to 9 ulps on
  at most 0.05 % (seeds 3-6); the exact tier's one logit per row holds
  four ulps, but a vocabulary-wide head does not; the targets exactly;
  ``masked_loss`` on the same logits 1e-6 relative;
- the mask sampler: its invariants exactly (value positions only, at
  least one per row, the forced position uniform over the 23), its rate
  within 4 sigma of 0.15 over 20,000 rows;
- three AdamW steps against ``optax.adamw(lr)`` on the same gradients:
  1e-6 of each leaf's largest magnitude (``torch.optim.AdamW`` rounds its
  decay ``p * (1 - lr * wd)`` on its own, optax folds it into the update);
- ``pretrained.msgpack`` both ways: the tree and its values bit for bit,
  the graft's key set equal to JAX's, the grafted trunk bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.train import pretrain as jax_pretrain
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig, load_config
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.models.bert import MASK_ID, transfer_encoder_params
from mlops_tpu_torch.train import pretrain
from mlops_tpu_torch.train.pipeline import load_init_state
from mlops_tpu_torch.weights import exact_params_from_numpy, flatten_tree, load_params
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

WIDTHS = dict(family="bert", token_dim=16, depth=2, heads=4)
SMALL = ["model.family=bert", "model.token_dim=16", "model.depth=2", "model.heads=4"]


def _noisy(params, seed):
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32), params
    )


def _rows(n, seed):
    from mlops_tpu_torch.schema.features import SCHEMA

    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, n) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    return cat, rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32)


def _mlm_pair(precision, seed=3):
    jcfg = JaxModelConfig(**WIDTHS, precision=precision)
    jmlm = jax_pretrain.build_mlm(jcfg)
    seq = jmlm.layout.seq_len
    params = jax.jit(lambda k: jmlm.init(
        {"params": k}, jnp.zeros((2, 9), jnp.int32), jnp.zeros((2, 14), jnp.float32),
        jnp.zeros((2, seq), bool), train=False,
    ))(jax.random.PRNGKey(seed))["params"]
    params = _noisy(params, seed)
    tmlm = pretrain.build_mlm(ModelConfig(**WIDTHS, precision=precision))
    load_params(tmlm, exact_params_from_numpy(params, "cpu"))
    return jmlm, tmlm.eval(), params


def _tol(want, precision):
    if precision == "f32":
        return 1e-5 * max(1.0, float(np.abs(want).max()))
    return 4 * 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)


# ------------------------------------------------------------------ model
def test_the_masked_lm_builds_flax_param_names_and_shapes():
    _, tmlm, params = _mlm_pair("f32")
    want = {k: np.asarray(v).shape for k, v in flatten_tree(params).items()}
    assert {k: tuple(v.shape) for k, v in tmlm.state_dict().items()} == want
    assert want["mlm_head.kernel"] == (16, tmlm.layout.vocab_size) == (16, 559)
    np.testing.assert_array_equal(tmlm.value_positions(), np.arange(2, 47, 2))
    assert len(tmlm.value_positions()) == 23 and MASK_ID == 3


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mlm_logits_and_masked_loss_match_the_flax_apply(precision):
    jmlm, tmlm, params = _mlm_pair(precision)
    cat, num = _rows(24, seed=4)
    mask = pretrain.sample_mask(np.random.default_rng(5), 24, tmlm.value_positions(), 48)

    def apply(p):
        return jmlm.apply({"params": p}, cat, num, mask, train=False)

    eager, targets = (np.asarray(a) for a in apply(params))
    jitted = np.asarray(jax.jit(apply)(params)[0])
    with torch.inference_mode():
        logits, got_targets = tmlm(torch.from_numpy(cat), torch.from_numpy(num),
                                   torch.from_numpy(mask), train=False)
    assert logits.dtype == torch.float32 and logits.shape == (24, 48, 559)
    np.testing.assert_array_equal(got_targets.numpy(), targets)
    got = logits.numpy()
    err = np.minimum(np.abs(got - eager) / _tol(eager, precision),
                     np.abs(got - jitted) / _tol(jitted, precision))
    if precision == "f32":
        assert (err <= 1.0).all(), err.max()
    else:  # no farther from JAX's two evaluations than they are from each other
        spread = np.abs(eager - jitted) / _tol(eager, precision)
        assert err.max() <= max(1.0, spread.max()), (err.max(), spread.max())
        assert (err > 1.0).mean() <= (spread > 1.0).mean(), (
            (err > 1.0).mean(), (spread > 1.0).mean())
    want_loss = float(jax_pretrain.masked_loss(eager, targets, mask))
    got_loss = float(pretrain.masked_loss(torch.from_numpy(eager), torch.from_numpy(targets),
                                          torch.from_numpy(mask)))
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)


def test_the_masked_tokens_are_the_mask_id_and_the_rest_the_rendering():
    _, tmlm, _ = _mlm_pair("f32")
    cat, num = (torch.from_numpy(a) for a in _rows(4, seed=6))
    seen = {}
    tmlm.tok_embed.register_forward_hook(lambda m, args, out: seen.update(ids=args[0]))
    mask = torch.zeros(4, 48, dtype=torch.bool)
    mask[:, 2] = True
    with torch.no_grad():
        _, targets = tmlm(cat, num, mask)
    assert (seen["ids"][:, 2] == MASK_ID).all()
    assert torch.equal(seen["ids"][:, 3:], targets[:, 3:])


# ---------------------------------------------------------------- sampler
def test_the_mask_sampler_keeps_its_invariants():
    pos = np.arange(2, 47, 2)
    masks = pretrain.sample_mask(np.random.default_rng(0), 20000, pos, 48)
    assert masks.shape == (20000, 48) and masks.dtype == bool
    off = np.setdiff1d(np.arange(48), pos)
    assert not masks[:, off].any()
    counts = masks.sum(1)
    assert (counts >= 1).all()
    # rows that drew none were forced to exactly one position
    p_none = 0.85 ** 23
    rate = masks[:, pos].mean()
    want = 0.15 + p_none / 23  # the forced share adds 1/23 per forced row
    sigma = np.sqrt(want * (1 - want) / masks[:, pos].size)
    assert abs(rate - want) <= 4 * sigma, (rate, want)
    forced = pretrain.sample_mask(np.random.default_rng(1), 200000, pos, 48)
    singles = forced[forced.sum(1) == 1][:, pos].argmax(1)
    hist = np.bincount(singles, minlength=23)
    assert hist.min() > 0.8 * hist.mean()  # every position drawn alike
    a = pretrain.step_mask(7, 3, 16, pretrain.build_mlm(ModelConfig(**WIDTHS)))
    b = pretrain.step_mask(7, 3, 16, pretrain.build_mlm(ModelConfig(**WIDTHS)))
    assert np.array_equal(a, b)  # a function of (seed, step)


# --------------------------------------------------------------- optimizer
def test_three_adamw_steps_match_optax_adamw():
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "scale": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adamw(3e-2)
    jp, state = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = pretrain.make_adamw(list(tp.values()), 3e-2)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, w in jp.items():
        w = np.asarray(w)
        np.testing.assert_allclose(tp[k].detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


# --------------------------------------------------------- file and graft
def _classifier(seed=0):
    jmodel = jax_build_model(JaxModelConfig(**WIDTHS))
    jvars = jax.jit(lambda k: jax_init_params(jmodel, k))(jax.random.PRNGKey(seed))
    return jvars, init_params(build_model(ModelConfig(**WIDTHS)), seed).state_dict()


def test_a_port_written_file_is_read_and_grafted_by_the_jax_package(tmp_path):
    _, tmlm, _ = _mlm_pair("f32")
    result = pretrain.PretrainResult(
        params={k: v.clone() for k, v in tmlm.state_dict().items()}, losses=[])
    path = tmp_path / pretrain.PRETRAINED_NAME
    pretrain.save_pretrained(result, path)
    jvars, tfresh = _classifier()
    want = jax_pretrain.load_pretrained_variables(
        path, JaxModelConfig(**WIDTHS), jvars)["params"]
    got = pretrain.load_pretrained_variables(path, ModelConfig(**WIDTHS), tfresh)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for k, v in result.params.items():
        if k.split(".")[0] != "mlm_head":
            np.testing.assert_array_equal(want[k], v.numpy())
            assert torch.equal(got[k], v)
    fresh = flatten_tree(jax.tree_util.tree_map(np.asarray, jvars["params"]))
    for k in want:
        if k.split(".")[0] in ("pooler", "head"):  # the heads keep their init
            np.testing.assert_array_equal(want[k], fresh[k])
            assert torch.equal(got[k], tfresh[k])


def test_a_jax_written_file_is_read_by_the_port(tmp_path):
    jmlm, _, params = _mlm_pair("f32", seed=9)
    path = tmp_path / "jax.msgpack"
    jax_pretrain.save_pretrained(jax_pretrain.PretrainResult(params=params, losses=[]), path)
    got = pretrain.load_pretrained(path, ModelConfig(**WIDTHS))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    # The port writes the bytes the JAX package writes for the same tree.
    pretrain.save_pretrained(pretrain.PretrainResult(params=got, losses=[]),
                             tmp_path / "port.msgpack")
    jtree = jax_pretrain.load_pretrained_variables(
        tmp_path / "port.msgpack", JaxModelConfig(**WIDTHS), _classifier()[0])["params"]
    assert set(flatten_tree(jtree)) == set(flatten_tree(_classifier()[0]["params"]))
    # A tree of other widths is refused, as flax's from_bytes refuses it.
    with pytest.raises(ValueError, match="shapes"):
        pretrain.load_pretrained(path, ModelConfig(**dict(WIDTHS, token_dim=32)))


def test_the_graft_copies_the_trunk_and_keeps_the_heads():
    tgt = {"tok_embed.embedding": torch.zeros(2), "block_0.Dense_0.kernel": torch.zeros(2),
           "ln_final.scale": torch.zeros(2), "pooler.kernel": torch.zeros(2),
           "head.bias": torch.zeros(1)}
    src = {"tok_embed.embedding": torch.ones(2), "block_0.Dense_0.kernel": torch.ones(2),
           "ln_final.scale": torch.ones(2), "mlm_head.kernel": torch.ones(3),
           "block_1.Dense_0.kernel": torch.ones(2)}
    merged = transfer_encoder_params(src, tgt)
    assert set(merged) == set(tgt)
    for k in ("tok_embed.embedding", "block_0.Dense_0.kernel", "ln_final.scale"):
        assert torch.equal(merged[k], src[k])
    for k in ("pooler.kernel", "head.bias"):
        assert torch.equal(merged[k], tgt[k])


@pytest.mark.parametrize("kw,message", [
    (dict(family="mlp"), "shares no trunk"),
    (dict(family="ft_transformer", token_dim=16, depth=2, heads=4), "shares no trunk"),
    (dict(WIDTHS, ensemble_size=2), "member axis of an ensemble"),
])
def test_init_params_refuses_what_it_cannot_graft(tmp_path, kw, message):
    config = load_config(["train.device=cpu", f"train.init_params={tmp_path}/x.msgpack",
                          f"registry.run_root={tmp_path / 'runs'}",
                          *[f"model.{k}={v}" for k, v in kw.items()]])
    with pytest.raises(ValueError, match=message):
        load_init_state(config)
    assert not (tmp_path / "runs").exists()


# ------------------------------------------------------------ end to end
def test_pretrain_then_fine_tune_through_the_cli(tmp_path, capsys):
    roots = [f"registry.root={tmp_path / 'registry'}", f"registry.run_root={tmp_path / 'runs'}"]
    assert main(["pretrain", "train.device=cpu", "data.rows=400", "train.steps=30",
                 "train.batch_size=32", "train.learning_rate=3e-3", *SMALL, *roots]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"pretrained", "rows", "loss_curve"} and out["rows"] == 400
    assert len(out["loss_curve"]) == 10
    assert out["loss_curve"][-1] < out["loss_curve"][0]
    path = out["pretrained"]
    assert path.endswith("/pretrained.msgpack")
    # the JAX package reads it
    jvars = _classifier(seed=0)[0]
    jax_pretrain.load_pretrained_variables(path, JaxModelConfig(**WIDTHS), jvars)
    # the grafted initial state: the trunk bit for bit from the file, the
    # heads from train.seed's fresh init
    config = load_config(["train.device=cpu", f"train.init_params={path}", *SMALL, *roots])
    state = load_init_state(config)
    saved = pretrain.load_pretrained(path, ModelConfig(**WIDTHS))
    fresh = init_params(build_model(ModelConfig(**WIDTHS)), 0).state_dict()
    for k, v in state.items():
        top = k.split(".")[0]
        assert torch.equal(v, fresh[k] if top in ("pooler", "head") else saved[k]), k
    assert main(["train", "train.device=cpu", "data.rows=400", "train.steps=4",
                 "train.eval_every=2", "train.batch_size=32", "train.distill_bulk=false",
                 f"train.init_params={path}", *SMALL, *roots]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trained["steps"] == 4
    assert jax_load_bundle(trained["bundle"]).model_config.family == "bert"


def test_pretrain_refuses_what_the_jax_package_refuses(capsys):
    with pytest.raises(SystemExit, match="pretrain supports model.family=bert"):
        main(["pretrain", "train.device=cpu", "model.family=mlp"])
    with pytest.raises(SystemExit, match="dense single-record masked-LM"):
        main(["pretrain", "train.device=cpu", "model.family=bert", "model.doc_records=3"])


def test_a_jax_pretrained_trunk_fine_tunes_in_the_port(tmp_path):
    columns, _ = jax_synthetic(300, seed=1)
    ds = JaxPreprocessor.fit(columns).encode(columns)
    result = jax_pretrain.pretrain_bert(JaxModelConfig(**WIDTHS), ds, steps=3, batch_size=16)
    path = tmp_path / "pretrained.msgpack"
    jax_pretrain.save_pretrained(result, path)
    config = load_config(["train.device=cpu", f"train.init_params={path}", *SMALL])
    state = load_init_state(config)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, result.params))
    for k, v in state.items():
        if k.split(".")[0] not in ("pooler", "head"):
            np.testing.assert_array_equal(v.numpy(), want[k])
    port = pretrain.pretrain_bert(ModelConfig(**WIDTHS), EncodedDataset(ds.cat_ids, ds.numeric),
                                  steps=3, batch_size=16, device="cpu")
    assert set(port.params) == set(want) and len(port.losses) == 3
