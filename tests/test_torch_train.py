"""The port's doc-model training against the JAX package's, on the CPU.

Both packages get the same JAX-initialized params (the JAX
``make_doc_train_step(mesh=None)``'s, carried across as numpy) and the
same batches, made by numpy from a seed. The model is small (token_dim 32,
depth 2, 4 heads, doc_records 3: S = 140 >= FLASH_MIN_SEQ) and f32.
Tolerances:

- one step's loss: 1e-6 (measured 0);
- gradients, leaf by leaf against ``jax.grad`` of the same loss: 2e-5 of
  the leaf's largest gradient (f32 arithmetic in another order through
  two blocks of softmax, LayerNorm and GELU; measured worst 5.4e-6), on
  the port's flash route (the plain versions through ``FlashAttention``)
  and on its dense route; JAX runs dense on the CPU;
- AdamW against optax.adamw over 3 steps: 2e-6 (the same arithmetic in
  another order; parameters near 1);
- the 5-step loss curve: 2e-5 (measured 1.2e-6: Adam's first steps move
  each weight by about the learning rate whatever the gradient's size);
- the EMA after one step, debiased, against the params: 1e-6 relative;
- predict-file on a port-trained bundle, JAX against the port: 2e-6 (the
  doc path's f32 tolerance);
- metrics and calibration against the JAX functions: 1e-6.
"""

import dataclasses
import json
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import mlops_tpu.train.pipeline as jax_pipeline
from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.bundle.registry import ModelRegistry as JaxRegistry
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.config import load_config as jax_load_config
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.data import write_csv_columns as jax_write_csv
from mlops_tpu.train import calibrate as jax_calibrate
from mlops_tpu.train import metrics as jax_metrics
from mlops_tpu.train.long_context import make_doc_train_step as jax_make_doc_train_step
from mlops_tpu.train.loop import sigmoid_bce as jax_sigmoid_bce
from mlops_tpu_torch.bundle import load_bundle, msgpack
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig, TrainConfig, load_config
from mlops_tpu_torch.models import init_params
from mlops_tpu_torch.models.layers import Dense, MultiHeadSelfAttention
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train import calibrate, metrics
from mlops_tpu_torch.train.long_context import build_doc_model, make_doc_train_step
from mlops_tpu_torch.train.loop import debias_ema, packaged_or_raw, sigmoid_bce
from mlops_tpu_torch.train.loop import batch_indices
from mlops_tpu_torch.train.pipeline import run_layout_training
from mlops_tpu_torch.weights import doc_params_from_numpy, flatten_tree, load_params
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

ROOT = Path(__file__).resolve().parent.parent
KW = dict(family="bert", doc_records=3, token_dim=32, depth=2, heads=4, precision="f32")
TRAIN = dict(batch_size=8, learning_rate=1e-3, weight_decay=1e-4)
GRAD_RTOL = 2e-5
CURVE_TOL = 2e-5
PRED_TOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The models here are tiny: a few torch threads beside XLA's own pool
    run them faster than one per core competing with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, (n, 3)) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    num = rng.normal(size=(n, 3, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(n) < 0.4).astype(np.float32)
    return cat, num, lab


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX doc trainer: its initial params, the loss gradients at
    them on one batch, and the losses of 5 steps on seeded batches."""
    trainer = jax_make_doc_train_step(
        JaxModelConfig(**KW), JaxTrainConfig(**TRAIN), mesh=None, seed=0
    )
    cat, num, lab = _docs(8, seed=1)

    def loss_of(params):
        logits = trainer.model.apply(
            {"params": params}, jnp.asarray(cat), jnp.asarray(num), train=True
        )
        return jax_sigmoid_bce(logits, jnp.asarray(lab))

    grads = jax.jit(jax.grad(loss_of))(trainer.params)
    docs = _docs(64, seed=2)
    params, opt_state, ema = trainer.params, trainer.opt_state, trainer.ema
    losses = []
    for step in range(1, 6):
        idx = batch_indices(64, 8, 0, step)
        params, opt_state, ema, loss = trainer.step_fn(
            params, opt_state, ema, *(jnp.asarray(a[idx]) for a in docs)
        )
        losses.append(float(loss))
    return {
        "params": _numpy(trainer.params),
        "batch": (cat, num, lab),
        "grads": flatten_tree(_numpy(grads)),
        "docs": docs,
        "losses": losses,
    }


def _port_trainer(params, ema_decay=0.0, flash=None):
    trainer = make_doc_train_step(
        ModelConfig(**KW), TrainConfig(**TRAIN, ema_decay=ema_decay, device="cpu"),
        seed=0,
    )
    load_params(trainer.model, doc_params_from_numpy(params, "cpu"))
    for mod in trainer.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            mod.use_flash = flash
    return trainer


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ------------------------------------------------------------- one step
@pytest.mark.parametrize("route", ["flash", "dense"])
def test_one_step_loss_and_gradients_match_jax(jax_run, route):
    trainer = _port_trainer(jax_run["params"], flash=route == "flash")
    cat, num, lab = _t(*jax_run["batch"])
    loss = sigmoid_bce(trainer.model(cat, num), lab)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    assert set(grads) == set(jax_run["grads"])
    for name, want in jax_run["grads"].items():
        err = np.abs(grads[name] - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), name
    # The step's own loss is make_doc_train_step's first loss (same batch
    # rule, same params).
    step_loss = trainer.step(*_t(*(a[batch_indices(64, 8, 0, 1)] for a in jax_run["docs"])))
    assert abs(float(step_loss) - jax_run["losses"][0]) <= 1e-6


def test_loss_curve_matches_the_jax_trainer(jax_run):
    trainer = _port_trainer(jax_run["params"], flash=True)
    losses = [
        float(trainer.step(*_t(*(a[batch_indices(64, 8, 0, step)] for a in jax_run["docs"]))))
        for step in range(1, 6)
    ]
    assert np.abs(np.asarray(losses) - jax_run["losses"]).max() <= CURVE_TOL


def test_sigmoid_bce_matches_jax_at_large_logits():
    logits = np.asarray([-80.0, -25.0, -3.0, 0.0, 2.5, 21.0, 90.0], np.float32)
    labels = np.asarray([1, 0, 1, 0, 1, 0, 1], np.float32)
    for pos_weight in (1.0, 2.5):
        want = float(jax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(labels), pos_weight))
        got = float(sigmoid_bce(*_t(logits, labels), pos_weight))
        assert abs(got - want) <= 1e-6 * abs(want)


# ------------------------------------------------------------ optimizer
def test_adamw_matches_optax_adamw():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr, wd = 1e-3, 0.05
    tx = optax.adamw(lr, weight_decay=wd)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.AdamW(tparams.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            assert np.abs(tparams[k].detach().numpy() - np.asarray(jparams[k])).max() <= 2e-6


def test_doc_trainer_accumulates_ema(jax_run):
    trainer = _port_trainer(jax_run["params"], ema_decay=0.9)
    params = trainer.params()
    assert packaged_or_raw(trainer.ema, params, 0.9, 0) is params
    trainer.step(*_t(*jax_run["batch"]))
    shipped = packaged_or_raw(trainer.ema, trainer.params(), 0.9, 1)
    for name, p in trainer.params().items():
        assert torch.allclose(shipped[name], p.detach(), rtol=1e-6, atol=1e-7), name
    assert not torch.equal(debias_ema(trainer.ema, 0.9, 2)["pos_embed"], shipped["pos_embed"])


# -------------------------------------------------------- initializers
def test_init_doc_params_follows_flax_initializers():
    model = init_params(
        build_doc_model(ModelConfig(family="bert", doc_records=3, token_dim=64, heads=4, depth=1)),
        seed=3,
    )
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense):
            continue
        w = mod.kernel.detach().numpy().ravel().astype(np.float64)
        std = np.sqrt(1.0 / mod.in_features)
        # flax lecun_normal: truncated at +-2 of the pre-truncation scale
        # std / 0.8796..., so the kept values have variance 1/fan_in.
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7, name
        assert abs(w.var() * mod.in_features - 1) <= 5 * np.sqrt(2 / w.size) + 0.02, name
        assert not mod.bias.detach().any(), name
    emb = model.tok_embed.embedding.detach().numpy()
    assert abs(emb.std() * np.sqrt(emb.shape[1]) - 1) <= 0.05
    assert abs(model.pos_embed.detach().numpy().std() / 0.02 - 1) <= 0.05


# --------------------------------------------------- metrics, calibration
def test_metrics_and_calibration_match_jax():
    rng = np.random.default_rng(4)
    logits = np.round(rng.normal(size=300), 1).astype(np.float32)  # ties
    labels = (rng.random(300) < 0.3).astype(np.float32)
    want = jax_metrics.binary_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = metrics.binary_metrics(*_t(logits, labels))
    for key, value in want.items():
        assert abs(float(got[key]) - float(value)) <= 1e-6, key
    assert float(metrics.roc_auc(torch.ones(4), torch.zeros(4))) == 0.5
    assert calibrate.calibration_record(logits, labels) == jax_calibrate.calibration_record(
        logits, labels
    )


def test_config_reads_the_job_toml_as_jax_does():
    toml = ROOT / "configs" / "long_context_job.toml"
    got = load_config(["model.seq_parallel=false", "train.steps=7"], toml_path=toml)
    want = jax_load_config(toml, overrides=["model.seq_parallel=false", "train.steps=7"], env={})
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    train = dataclasses.asdict(got.train)
    assert train.pop("device") == "cuda"
    assert train == dataclasses.asdict(want.train)
    for section, fields in (("data", ("rows", "seed", "valid_fraction", "train_path")),
                            ("monitor", ("outlier_quantile", "drift_ref_size")),
                            ("registry", ("root", "model_name", "experiment_name",
                                          "run_root", "run_name"))):
        for field in fields:
            assert getattr(getattr(got, section), field) == getattr(
                getattr(want, section), field
            ), (section, field)
    assert tomllib.loads(toml.read_text())["model"]["seq_parallel"] is True
    with pytest.raises(KeyError, match="hpo.nope"):
        load_config(["hpo.nope=3"])
    # The exact tier's job: its sections parse as the JAX package's, its
    # [hpo] table (the tune command's) too.
    job = ROOT / "configs" / "train_register_job.toml"
    got, want = load_config([], toml_path=job), jax_load_config(job, env={})
    for section in ("data", "model", "train", "hpo"):
        for field, value in dataclasses.asdict(getattr(got, section)).items():
            if hasattr(getattr(want, section), field):
                assert value == getattr(getattr(want, section), field), (section, field)
    assert dataclasses.asdict(got.hpo) == dataclasses.asdict(want.hpo)


# ------------------------------------------------------------ end to end
TINY = [
    "model.family=bert", "model.doc_records=3", "model.token_dim=16",
    "model.heads=2", "model.depth=1", "model.precision=f32", "data.rows=400",
    "train.batch_size=8", "train.device=cpu",
]


def _train(tmp, run_name, steps, capsys, eval_every=2, extra=()):
    args = [
        "train", *TINY, f"train.steps={steps}", f"train.eval_every={eval_every}",
        f"registry.root={tmp / 'registry'}", f"registry.run_root={tmp / 'runs'}",
        f"registry.run_name={run_name}", *extra,
    ]
    capsys.readouterr()
    assert main(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def history_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_history") / "history.csv"
    columns, labels = jax_synthetic(3 * 11 + 2, seed=5)
    jax_write_csv(path, columns, labels)
    return path


def test_train_cli_writes_a_bundle_both_packages_serve(tmp_path, capsys, history_csv, monkeypatch):
    out = _train(tmp_path, "e2e", 3, capsys)
    # The JAX train command's JSON keys, read off its printer.
    monkeypatch.setattr(
        jax_pipeline, "run_layout_training",
        lambda config, run_name=None: jax_pipeline.PipelineResult(
            None, None, jax_pipeline.TrainResult({}, {}, [], 0), Path(".")
        ),
    )
    capsys.readouterr()
    assert jax_main(["train", "model.doc_records=3"]) == 0
    assert set(out) == set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert (out["steps"], out["packaged_step"]) == (3, 3)
    assert all(np.isfinite(v) for v in out["metrics"].values())

    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [2, 3]
    assert set(rows[-1]) == {"ts", "step", "loss", *out["metrics"]}

    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    assert manifest["flavor"] == "doc"
    assert manifest["model_config"] == json.loads(
        json.dumps(dataclasses.asdict(load_config(TINY).model))
    )
    assert manifest["metrics"] == out["metrics"]
    assert manifest["tags"]["trained_with"] == "long_context dense"
    assert manifest["tags"]["run_name"] == "e2e"
    assert set(manifest["calibration"]) == {
        "temperature", "val_nll_uncalibrated", "val_nll_calibrated"
    }
    # doc_params.msgpack is the bundle's params, in flax's encoding.
    raw = serialization.msgpack_restore((Path(out["run_dir"]) / "doc_params.msgpack").read_bytes())
    for name, value in flatten_tree(raw).items():
        assert np.array_equal(value, load_bundle(out["bundle"]).model.state_dict()[name].numpy())

    args = [
        "predict-file", f"data.train_path={history_csv}",
        f"serve.model_directory={out['bundle']}", "serve.max_batch=4",
    ]
    capsys.readouterr()
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(args + ["serve.device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["documents"] == want["documents"] == 11
    assert np.abs(np.asarray(got["predictions"]) - want["predictions"]).max() <= PRED_TOL
    assert jax_load_bundle(out["bundle"]).flavor == "doc"

    name, version = out["model_uri"][len("models:/"):].split("/")
    resolved = JaxRegistry(tmp_path / "registry").resolve(name, version)
    assert (resolved / "params.msgpack").read_bytes() == (
        Path(out["bundle"]) / "params.msgpack"
    ).read_bytes()


def test_a_rerun_with_the_same_run_name_resumes(tmp_path, capsys):
    _train(tmp_path, "resumed", 2, capsys, eval_every=1)
    resumed = _train(tmp_path, "resumed", 4, capsys, eval_every=1)
    straight = _train(tmp_path, "straight", 4, capsys, eval_every=1)
    assert resumed["metrics"] == straight["metrics"]
    params = {
        run: msgpack.unpackb((Path(out["run_dir"]) / "doc_params.msgpack").read_bytes())
        for run, out in (("resumed", resumed), ("straight", straight))
    }
    for name, value in flatten_tree(params["straight"]).items():
        assert torch.equal(flatten_tree(params["resumed"])[name], value), name

    def journal(out):
        rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    assert [r["step"] for r in journal(resumed)] == [1, 2, 3, 4]
    assert journal(resumed) == journal(straight)


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize(
    "overrides,match",
    [
        (["model.seq_parallel=true"], "seq_parallel"),
        (["model.pipeline_stages=2"], "cannot combine"),
        (["model.tensor_parallel=2"], "cannot combine"),
        (["model.doc_records=1", "model.family=mlp"], "run_training"),
        (["train.init_params=pretrained.msgpack"], "init_params"),
    ],
)
def test_train_refuses_what_is_not_ported(tmp_path, overrides, match):
    config = load_config(
        [*TINY, "train.steps=1", f"registry.run_root={tmp_path}", *overrides]
    )
    with pytest.raises(ValueError, match=match):
        run_layout_training(config)
    with pytest.raises(ValueError, match="needs a mesh with a 'seq' axis"):
        make_doc_train_step(ModelConfig(**KW, seq_parallel=True), TrainConfig(device="cpu"))


@pytest.mark.parametrize("case", ["gs_registry", "tensorboard"])
def test_the_doc_trainer_takes_a_gs_registry_and_tensorboard(tmp_path, capsys, monkeypatch, case):
    """What the doc trainer refused until the port had them: a ``gs://``
    registry the JAX package resolves, and TensorBoard events beside
    metrics.jsonl."""
    from torch_gcs import install_fake_bucket

    if case == "gs_registry":
        install_fake_bucket(monkeypatch, tmp_path / "home")
        out = _train(tmp_path, "gs", 2, capsys, extra=("registry.root=gs://bucket/models",))
        assert out["model_uri"] == "models:/credit-default-uci-custom/1"
        resolved = JaxRegistry("gs://bucket/models").resolve("credit-default-uci-custom", "1")
        assert (resolved / "manifest.json").read_bytes() == \
            (Path(out["bundle"]) / "manifest.json").read_bytes()
        assert jax_load_bundle(resolved).flavor == "doc"
    else:
        out = _train(tmp_path, "tb", 2, capsys, extra=(f"train.tensorboard_dir={tmp_path / 'tb'}",))
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
        rows = (Path(out["run_dir"]) / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(r)["step"] for r in rows] == [2]


def test_train_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    overrides = [o for o in TINY if o != "train.device=cpu"]
    for extra in ([], ["train.device=cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", *overrides, *extra, f"registry.run_root={tmp_path}"])
    assert not any(tmp_path.iterdir())
