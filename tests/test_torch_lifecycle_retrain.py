"""The port's lifecycle retrain against the JAX package's, on the CPU,
from the same JAX-written incumbent (``tiny_pipeline``: mlp, hidden
(32, 32), embed 4) and the same labeled drifted window (1,500 rows,
numerics x10; 50 steps, as ``tests/test_lifecycle.py`` runs it).

The port's candidate loads in both packages, keeps the incumbent's K-S
width and scores a validation AUC within 0.01 of the JAX candidate's
(different init bits and batch orders: the same distribution of
results, not the same numbers); a completed checkpoint is never resumed,
a checkpoint wins over the incumbent's params; the refusals, the
preprocessor refit, the reservoir's monitor refit; and the offline
``lifecycle`` command gives the JAX command's decision and exit code.
"""

import copy
import json

import numpy as np
import pytest
import torch

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.lifecycle import run_retrain as jax_run_retrain
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import TrainConfig
from mlops_tpu_torch.data import generate_synthetic
from mlops_tpu_torch.data.ingest import write_csv_columns
from mlops_tpu_torch.lifecycle.retrain import LifecycleError, run_retrain
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.loop import fit
from torch_lifecycle import (  # noqa: F401
    budget,
    jax_config,
    port_config,
    scenery,
)
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

AUC_EPS = 0.01


@pytest.fixture(scope="module")
def config(scenery):
    return port_config(scenery["td"], scenery["labeled"])


@pytest.fixture(scope="module")
def candidate(scenery, config):
    return run_retrain(scenery["bundle"], config, generation=2)


def test_the_candidate_loads_in_both_packages_at_the_incumbents_ks_width(
    scenery, candidate
):
    incumbent = scenery["bundle"]
    for loaded in (load_bundle(candidate.candidate_dir),
                   jax_load_bundle(candidate.candidate_dir)):
        assert loaded.manifest["tags"]["lifecycle"] == "candidate"
        assert loaded.manifest["tags"]["parent_generation"] == "1"
        assert (np.asarray(loaded.monitor.num_ref_sorted).shape
                == tuple(incumbent.monitor.num_ref_sorted.shape))
        assert loaded.manifest["calibration"]["temperature"] > 0
    ckpt = candidate.candidate_dir.parent.parent / "checkpoints" / "gen-2-t1"
    assert (ckpt / "latest.json").is_file()
    assert candidate.holdout.n == 300 and candidate.holdout.labels is not None
    assert candidate.holdout_incumbent is candidate.holdout
    assert candidate.labeled_rows == 1500 and candidate.fit_s > 0


def test_the_candidates_auc_is_within_001_of_the_jax_candidates(scenery, candidate):
    jax_bundle = jax_load_bundle(scenery["bundle_dir"])
    config = jax_config(scenery["td"] / "jax", scenery["labeled"])
    want = jax_run_retrain(jax_bundle, config, generation=2)
    got = candidate.metrics["validation_roc_auc_score"]
    assert abs(got - want.metrics["validation_roc_auc_score"]) <= AUC_EPS, (
        got, want.metrics)
    np.testing.assert_array_equal(candidate.holdout.labels, want.holdout.labels)
    assert set(candidate.metrics) == set(want.metrics)


def test_a_completed_checkpoint_is_never_resumed(scenery, config):
    first = run_retrain(scenery["bundle"], config, generation=2, attempt=4)
    latest = first.candidate_dir.parent.parent / "checkpoints" / "gen-2-t4" / "latest.json"
    mtime = latest.stat().st_mtime_ns
    second = run_retrain(scenery["bundle"], config, generation=2, attempt=4)
    assert latest.stat().st_mtime_ns > mtime  # retrained, checkpointed anew
    assert second.metrics
    other = run_retrain(scenery["bundle"], config, generation=2, attempt=5)
    assert other.candidate_dir.name == "gen-2-t5"


def test_a_checkpoint_wins_over_the_init_params_and_the_init_is_used(scenery, tmp_path):
    ds = scenery["bundle"].preprocessor.encode(*generate_synthetic(600, seed=1))
    train, valid = ds.slice(np.arange(500)), ds.slice(np.arange(500, 600))
    model_config = scenery["bundle"].model_config
    init = scenery["bundle"].model.state_dict()
    frozen = TrainConfig(steps=5, eval_every=5, batch_size=64, learning_rate=0.0,
                         weight_decay=0.0, device="cpu")
    still = fit(build_model(model_config), train, valid, frozen, init_state=init)
    for name, value in init.items():
        torch.testing.assert_close(still.params[name], value, rtol=0, atol=0)
    moving = TrainConfig(steps=10, eval_every=5, batch_size=64, device="cpu")
    done = fit(build_model(model_config), train, valid, moving,
               checkpoint_dir=tmp_path / "ckpt")
    resumed = fit(build_model(model_config), train, valid, moving, init_state=init,
                  checkpoint_dir=tmp_path / "ckpt")
    assert resumed.history == []
    for name, value in done.params.items():
        torch.testing.assert_close(resumed.params[name], value, rtol=0, atol=0)


def test_refit_preprocessor_keeps_an_incumbent_encoded_holdout(scenery, config):
    refit = copy.deepcopy(config)
    refit.lifecycle.refit_preprocessor = True
    result = run_retrain(scenery["bundle"], refit, generation=2, attempt=6)
    assert result.refit_preprocessor
    assert result.holdout_incumbent is not result.holdout
    np.testing.assert_array_equal(result.holdout_incumbent.labels, result.holdout.labels)
    assert not np.allclose(result.holdout_incumbent.numeric, result.holdout.numeric)
    assert not np.allclose(result.bundle.preprocessor.numeric_mean,
                           scenery["bundle"].preprocessor.numeric_mean)


def test_the_monitor_refits_on_the_reservoir_window(scenery, config):
    rng = np.random.default_rng(2)
    window = (
        rng.integers(0, 2, (1500, SCHEMA.num_categorical)).astype(np.int32),
        rng.normal(7.0, 0.1, (1500, SCHEMA.num_numeric)).astype(np.float32),
    )
    result = run_retrain(scenery["bundle"], config, generation=2, attempt=3,
                         reservoir_window=window)
    ref = result.bundle.monitor.num_ref_sorted.numpy()
    assert ref.shape == tuple(scenery["bundle"].monitor.num_ref_sorted.shape)
    assert abs(float(ref.mean()) - 7.0) < 0.5


def test_the_refusals_are_the_jax_retrains(scenery, config, tmp_path):
    unlabeled = copy.deepcopy(config)
    unlabeled.lifecycle.labeled_path = ""
    with pytest.raises(LifecycleError, match="labeled_path is empty"):
        run_retrain(scenery["bundle"], unlabeled, generation=2)
    small = copy.deepcopy(config)
    small.lifecycle.min_labeled_rows = 5000
    with pytest.raises(LifecycleError, match="1500 rows < lifecycle.min_labeled_rows=5000"):
        run_retrain(scenery["bundle"], small, generation=2)
    columns, _ = generate_synthetic(600, seed=0)
    write_csv_columns(tmp_path / "nolabels.csv", columns)
    nolabels = copy.deepcopy(config)
    nolabels.lifecycle.labeled_path = str(tmp_path / "nolabels.csv")
    with pytest.raises(LifecycleError, match="no target column"):
        run_retrain(scenery["bundle"], nolabels, generation=2)

    class Tree:
        flavor = "sklearn"

    with pytest.raises(LifecycleError, match="flax-flavor incumbent"):
        run_retrain(Tree(), config, generation=2)


@pytest.mark.parametrize("max_ece,code", [(0.3, 0), (1e-4, 3)])
def test_the_lifecycle_command_decides_as_the_jax_command(
    scenery, tmp_path, capsys, max_ece, code
):
    from mlops_tpu import cli as jax_cli
    from mlops_tpu_torch import cli

    records = []
    for main, extra, name in ((jax_cli.main, [], "jax"),
                              (cli.main, ["train.device=cpu", "serve.device=cpu"], "port")):
        args = [
            "lifecycle", f"serve.model_directory={scenery['bundle_dir']}",
            f"lifecycle.labeled_path={scenery['labeled']}",
            f"lifecycle.dir={tmp_path / name}", "lifecycle.retrain_steps=50",
            "lifecycle.min_labeled_rows=500", f"lifecycle.max_ece={max_ece}",
            "serve.warmup_batch_sizes=1,8", f"registry.root={tmp_path / name / 'registry'}",
            *extra,
        ]
        assert main(args) == code, name
        records.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    jax_record, port_record = records
    assert set(port_record) == set(jax_record)
    assert port_record["gates"]["passed"] == jax_record["gates"]["passed"] == (code == 0)
    assert [r.split(":")[0] for r in port_record["gates"]["reasons"]] == [
        r.split(":")[0] for r in jax_record["gates"]["reasons"]]
    assert (port_record["model_uri"] is None) == (jax_record["model_uri"] is None)
    assert port_record["labeled_rows"] == jax_record["labeled_rows"] == 1500
    assert abs(port_record["auc_candidate"] - jax_record["auc_candidate"]) <= AUC_EPS


def test_the_retrain_and_the_lifecycle_command_need_the_card_unless_asked(
    scenery, config, tmp_path
):
    """Like every entry point of the port, the retrain runs on the card
    unless the caller asks for the CPU; without one it raises."""
    from mlops_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    card = copy.deepcopy(config)
    card.train.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_retrain(scenery["bundle"], card, generation=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["lifecycle", f"serve.model_directory={scenery['bundle_dir']}",
                  f"lifecycle.labeled_path={scenery['labeled']}",
                  f"lifecycle.dir={tmp_path}", "lifecycle.min_labeled_rows=500"])
