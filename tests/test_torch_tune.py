"""``tune`` end to end: the port's ``run_tuning`` and CLI against the JAX
package's, on the CPU.

One config in both packages (4,000 synthetic rows, mlp (32, 32), embed 4,
f32, batch 128, 3 trials of 150 steps, pos_weight sampled in [1, 4]):
``trials.jsonl`` and ``best.json`` have the same keys and hyperparams;
the winner's validation AUC is within 0.02 of JAX's (the batches and
initial weights come from other random streams; the max of three trials
of one package moves by about 0.01 between seeds); each package's tuned
bundle serves in the other's engine with the same predictions (f32: 1e-5,
``tests/torch_students.py``). Architecture groups run with the JAX
sweep's per-group initial params and indices (``tests/torch_hpo_seams.py``):
merged trial records, surfaced structural hyperparams, the winner's
config and index as the JAX package's (metrics 1e-4). Resume restores
finished groups without a training step; a changed dataset recomputes.
The refusals name the JAX package's reasons or their ROADMAP item; a
moe config and a moe group, refused until the family was ported, tune
into a moe bundle both packages load."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import HPOConfig as JaxHPOConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu.train import hpo as jax_hpo
from mlops_tpu.train.pipeline import run_tuning as jax_run_tuning
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig, load_config
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.train import hpo
from mlops_tpu_torch.train.pipeline import run_tuning
from torch_hpo_seams import group_seams, split
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

AUC_GAP = 0.02
PRED_TOL = 1e-5
METRIC_TOL = 1e-4
JOB = dict(rows=4000, hidden_dims=(32, 32), embed_dim=4, batch=128, trials=3, steps=150)
OVERRIDES = [
    f"data.rows={JOB['rows']}", "model.family=mlp", "model.hidden_dims=32,32",
    "model.embed_dim=4", "model.precision=f32", f"train.batch_size={JOB['batch']}",
    f"hpo.trials={JOB['trials']}", f"hpo.steps={JOB['steps']}", "train.device=cpu",
]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_config(root: Path) -> JaxConfig:
    config = JaxConfig()
    config.data.rows = JOB["rows"]
    config.model = JaxModelConfig(
        family="mlp", hidden_dims=JOB["hidden_dims"], embed_dim=JOB["embed_dim"],
        precision="f32",
    )
    config.train = JaxTrainConfig(batch_size=JOB["batch"])
    config.hpo = JaxHPOConfig(trials=JOB["trials"], steps=JOB["steps"])
    config.registry.root = str(root / "registry")
    config.registry.run_root = str(root / "runs")
    return config


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """The same tune in both packages: the JAX ``run_tuning`` and the
    port's ``tune`` CLI, each into its own registry."""
    root = tmp_path_factory.mktemp("tune")
    jax_result, jax_hpo_result = jax_run_tuning(_jax_config(root / "jax"), run_name="job")
    port_root = root / "port"
    argv = ["tune", *OVERRIDES, f"registry.root={port_root / 'registry'}",
            f"registry.run_root={port_root / 'runs'}", "registry.run_name=job"]
    return jax_result, jax_hpo_result, argv, port_root


def _run_cli(argv, capsys) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _lines(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_tune_writes_what_the_jax_package_writes(tuned, capsys):
    jax_result, jax_hpo_result, argv, port_root = tuned
    out = _run_cli(argv, capsys)
    assert set(out) == {"bundle", "model_uri", "best_trial", "best_hyperparams",
                        "metrics", "trials"}
    assert out["trials"] == len(jax_hpo_result.trials) == JOB["trials"]
    assert out["model_uri"] == "models:/credit-default-uci-custom/1"
    run_dir = port_root / "runs" / "job"
    got, want = _lines(run_dir / "trials.jsonl"), _lines(jax_result.run_dir / "trials.jsonl")
    assert [sorted(t) for t in got] == [sorted(t) for t in want]
    assert [(t["trial"], t["hyperparams"]) for t in got] == [
        (t["trial"], t["hyperparams"]) for t in want]
    assert [sorted(t["metrics"]) for t in got] == [sorted(t["metrics"]) for t in want]
    best, jbest = (json.loads((d / "best.json").read_text())
                   for d in (run_dir, jax_result.run_dir))
    assert sorted(best) == sorted(jbest) == ["best_index", "hyperparams", "metrics"]
    assert best["hyperparams"] == got[best["best_index"]]["hyperparams"] == out["best_hyperparams"]
    assert best["metrics"] == out["metrics"] == got[out["best_trial"]]["metrics"]
    auc, jauc = (b["metrics"]["validation_roc_auc_score"] for b in (best, jbest))
    assert auc == max(t["metrics"]["validation_roc_auc_score"] for t in got)
    assert abs(auc - jauc) <= AUC_GAP, (auc, jauc)
    # The bundle and registry tags, and the manifest's model config.
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    jmanifest = json.loads((jax_result.bundle_dir / "manifest.json").read_text())
    assert sorted(manifest["tags"]) == sorted(jmanifest["tags"])
    assert manifest["tags"]["best_trial"] == str(out["best_trial"])
    assert manifest["tags"]["learning_rate"] == f"{out['best_hyperparams']['learning_rate']:.6g}"
    assert manifest["model_config"] == jmanifest["model_config"]
    assert manifest["metrics"] == out["metrics"]
    index = json.loads((port_root / "registry" / "credit-default-uci-custom" /
                        "index.json").read_text())
    assert index["versions"][0]["tags"] == {"run_name": "job", "best_trial": str(out["best_trial"])}


def test_tuned_bundles_serve_in_both_packages(tuned, capsys):
    jax_result, _, argv, port_root = tuned
    port_bundle = port_root / "runs" / "job" / "bundle"
    if not port_bundle.exists():
        _run_cli(argv, capsys)
    records = [{"age": 25.0 + i, "sex": "female" if i % 2 else "male",
                "credit_limit": 1000.0 * i} for i in range(12)]
    for bundle_dir in (port_bundle, jax_result.bundle_dir):
        want = JaxEngine(jax_load_bundle(bundle_dir), buckets=(16,)).predict_records(records)
        got = InferenceEngine(load_bundle(bundle_dir), buckets=(16,), device="cpu"
                              ).predict_records(records)
        np.testing.assert_allclose(got["predictions"], want["predictions"], atol=PRED_TOL, rtol=0)
        assert got["outliers"] == want["outliers"]


def test_a_rerun_restores_every_group_without_a_step(tuned, capsys, monkeypatch):
    """An architecture sweep run again under the same run_name (the Job
    retried): every finished group is restored, no step trains, best.json
    and trials.jsonl are rewritten with the same content, and a new
    version is registered. (Without ``hpo.architectures`` the JAX package
    keeps no group record and a rerun trains again; so does the port.)"""
    _, _, argv, port_root = tuned
    argv = [a.replace("registry.run_name=job", "registry.run_name=groups") for a in argv]
    argv += ["hpo.architectures=hidden_dims=8x8,embed_dim=2;family=linear", "hpo.steps=20"]
    first = _run_cli(argv, capsys)
    run_dir = port_root / "runs" / "groups"
    before = {n: (run_dir / n).read_text() for n in ("best.json", "trials.jsonl")}
    assert sorted(p.name for p in (run_dir / "hpo_groups").iterdir()) == [
        "group_0.json", "group_0.pt", "group_1.json", "group_1.pt"]

    def no_step(self):
        raise AssertionError("a restored sweep trained a step")

    monkeypatch.setattr(hpo.TrialStack, "step", no_step)
    out = _run_cli(argv, capsys)
    assert {n: (run_dir / n).read_text() for n in before} == before
    assert (out["best_trial"], out["best_hyperparams"], out["metrics"]) == (
        first["best_trial"], first["best_hyperparams"], first["metrics"])
    assert int(out["model_uri"].rsplit("/", 1)[1]) == int(first["model_uri"].rsplit("/", 1)[1]) + 1


# ------------------------------------------------------ architecture groups
SPECS = ("hidden_dims=8x8,embed_dim=4", "family=linear", "hidden_dims=16,embed_dim=2")


def _groups_config():
    kw = dict(family="mlp", hidden_dims=(32, 32), embed_dim=4, precision="f32", dropout=0.0)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def test_architecture_groups_merge_and_select_as_the_jax_package(tmp_path):
    (jtrain, jvalid), (ptrain, pvalid) = split(1500, seed=8)
    jmc, pmc = _groups_config()
    hkw = dict(trials=2, steps=6, architectures=SPECS)
    jwin, want = jax_hpo.run_architecture_hpo(
        jmc, JaxTrainConfig(batch_size=32), JaxHPOConfig(**hkw), jtrain, jvalid)
    phc = HPOConfig(**hkw)
    seams = group_seams(32, jtrain.n)(phc)
    pwin, got = hpo.run_architecture_hpo(
        pmc, TrainConfig(batch_size=32, device="cpu"), phc, ptrain, pvalid,
        device="cpu", resume_dir=tmp_path, seams=seams,
    )
    assert dataclasses.asdict(pwin) == dataclasses.asdict(jwin)
    assert got.best_index == want.best_index
    assert got.best_hyperparams == want.best_hyperparams
    assert "family" in got.best_hyperparams
    assert len(got.trials) == len(want.trials) == 2 * len(SPECS)
    for g, w in zip(got.trials, want.trials):
        assert (g["group"], g["architecture"], g["hyperparams"]) == (
            w["group"], w["architecture"], w["hyperparams"])
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= METRIC_TOL
    # Resume: every group restored, none trained; the same result.
    steps = []
    real = hpo.TrialStack.step

    def counted(self):
        steps.append(1)
        return real(self)

    hpo.TrialStack.step = counted
    try:
        _, again = hpo.run_architecture_hpo(
            pmc, TrainConfig(batch_size=32, device="cpu"), phc, ptrain, pvalid,
            device="cpu", resume_dir=tmp_path, seams=seams,
        )
        assert steps == []
        assert again.trials == got.trials and again.best_index == got.best_index
        for k, v in got.best_params.items():
            assert torch.equal(again.best_params[k], v)
        # A changed dataset (one label flipped) recomputes every group.
        labels = ptrain.labels.copy()
        labels[0] = 1 - labels[0]
        changed = dataclasses.replace(ptrain, labels=labels)
        hpo.run_architecture_hpo(
            pmc, TrainConfig(batch_size=32, device="cpu"), phc, changed, pvalid,
            device="cpu", resume_dir=tmp_path,
        )
        assert len(steps) == len(SPECS) * phc.steps
    finally:
        hpo.TrialStack.step = real


# ------------------------------------------------------------ packaging
def test_an_ensemble_winner_ships_its_bulk_student_and_never_a_quant_one(tmp_path, capsys):
    out = _run_cli([
        "tune", "data.rows=2000", "model.family=mlp", "model.hidden_dims=8",
        "model.embed_dim=2", "model.ensemble_size=2", "model.precision=f32",
        "train.batch_size=64", "hpo.trials=2", "hpo.steps=20", "train.device=cpu",
        "train.distill_quant=true", f"registry.root={tmp_path / 'reg'}",
        f"registry.run_root={tmp_path / 'runs'}",
    ], capsys)
    bundle = Path(out["bundle"])
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["model_config"]["ensemble_size"] == 2
    assert "bulk" in manifest and (bundle / "bulk_params.msgpack").exists()
    assert "quant" not in manifest and not (bundle / "quant_params.msgpack").exists()
    assert load_bundle(bundle).flavor == "flax"


# ------------------------------------------------------------- refusals
# The moe family is ported (A9): a moe config and a moe group tune (at
# token_dim 16, depth 1, 4 experts) into a moe bundle both packages load.
_SMALL_MOE = ["model.token_dim=16", "model.depth=1", "model.heads=2",
              "model.num_experts=4", "train.distill_bulk=false"]


@pytest.mark.parametrize("overrides,match", [
    (["model.family=gbm"], "sklearn baseline families"),
    (["model.family=rf"], "sklearn baseline families"),
    (["model.doc_records=3"], "layout knobs"),
    (["model.pipeline_stages=2"], "layout knobs"),
    pytest.param(["model.family=moe", *_SMALL_MOE], None,
                 id="overrides4-'moe' is not ported .*A9"),
    pytest.param(["hpo.architectures=family=moe", *_SMALL_MOE], None,
                 id="overrides5-'moe' is not ported .*A9"),
    (["hpo.architectures=family=gbm"], "not vmappable"),
    (["hpo.strategy=tpe"], "hpo.strategy must be 'random' or 'sha'"),
])
def test_tune_refuses_what_it_cannot_sweep(tmp_path, overrides, match):
    config = load_config([
        "data.rows=300", "hpo.trials=2", "hpo.steps=2", "train.device=cpu",
        f"registry.root={tmp_path / 'reg'}", f"registry.run_root={tmp_path / 'runs'}",
        *overrides,
    ])
    if match is None:
        result, hpo_result = run_tuning(config, register=False)
        assert len(hpo_result.trials) == 2
        assert jax_load_bundle(result.bundle_dir).model_config.family == "moe"
        assert load_bundle(result.bundle_dir).model_config.family == "moe"
        return
    with pytest.raises(ValueError, match=match):
        run_tuning(config)


def test_both_packages_tune_into_one_gs_registry(tmp_path, monkeypatch, capsys):
    """The deployed Job's registry on a bucket: the JAX ``tune`` registers
    version 1, the port's ``tune`` version 2 beside it; each package
    resolves the other's version to the bytes its run wrote."""
    from mlops_tpu.bundle.registry import ModelRegistry as JaxRegistry
    from mlops_tpu.cli import main as jax_main
    from mlops_tpu_torch.bundle.registry import ModelRegistry
    from torch_gcs import install_fake_bucket

    install_fake_bucket(monkeypatch, tmp_path / "home")
    small = ["data.rows=800", "model.hidden_dims=8", "model.embed_dim=2",
             "model.precision=f32", "train.batch_size=32", "hpo.trials=2", "hpo.steps=6",
             "registry.root=gs://bucket/models", f"registry.run_root={tmp_path / 'runs'}"]
    out = {}
    for who, entry, extra in (("jax", jax_main, []), ("port", main, ["train.device=cpu"])):
        capsys.readouterr()
        assert entry(["tune", *small, f"registry.run_name={who}", *extra]) == 0
        out[who] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    name = "credit-default-uci-custom"
    assert [out[w]["model_uri"] for w in ("jax", "port")] == [f"models:/{name}/1", f"models:/{name}/2"]
    for registry in (JaxRegistry("gs://bucket/models"), ModelRegistry("gs://bucket/models")):
        for who, version in (("jax", "1"), ("port", "2")):
            resolved = registry.resolve(name, version)
            for part in ("manifest.json", "params.msgpack"):
                assert (resolved / part).read_bytes() == \
                    (Path(out[who]["bundle"]) / part).read_bytes(), (who, part)
        assert [v["tags"]["run_name"] for v in registry.list_versions(name)] == ["jax", "port"]


def test_the_jax_refusal_texts_are_the_ones_copied(tmp_path):
    for family in ("gbm",):
        config = _jax_config(tmp_path)
        config.model = JaxModelConfig(family=family)
        with pytest.raises(ValueError) as want:
            jax_run_tuning(config)
        port = load_config([f"model.family={family}", "train.device=cpu"])
        with pytest.raises(ValueError) as got:
            run_tuning(port)
        assert str(got.value) == str(want.value)
    config = _jax_config(tmp_path)
    config.model = JaxModelConfig(doc_records=3)
    with pytest.raises(ValueError) as want:
        jax_run_tuning(config)
    with pytest.raises(ValueError) as got:
        run_tuning(load_config(["model.doc_records=3", "train.device=cpu"]))
    assert str(got.value) == str(want.value)


def test_tune_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    config = load_config(["data.rows=300", "hpo.trials=2", "hpo.steps=2",
                          f"registry.root={tmp_path}", f"registry.run_root={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tuning(config)
