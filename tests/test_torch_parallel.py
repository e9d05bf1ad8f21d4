"""The port's multi-rank building blocks (``mlops_tpu_torch/parallel``)
and its data mesh against the JAX package's, on the CPU.

The port runs as one group of 4 gloo ranks (``tests/torch_dist.py``,
jobs in ``tests/torch_dist_jobs.py``), started once for this file; the
JAX package runs in this process on meshes of 2 and 4 of its 8
simulated devices. Inputs come from a numpy seed (and the JAX sweep's own
init and batches, through ``weights.py``). Tolerances:

- the collectives (the port's ``pmean``, ``gather`` and
  ``ring_shift_on`` against the JAX ``pmean_over_data``,
  ``all_gather_rows`` and ``ring_shift``) and their gradients: f32 1e-6
  (a mean over 2 or 4 ranks in another order; gathers and shifts are
  copies, bitwise);
- the bulk path's row split (``row_block``, ``gather_tensor``) against
  the JAX ``make_sharded_batch_scorer``: f32 1e-6;
- ``param_shardings``: equal specs, every family, ensembles, and dims the
  axis does not divide;
- ``tune`` over a data mesh (random search on 2 and 4 ranks, SHA on 4;
  trials padded): the
  trial records, winner and metrics as ``test_torch_hpo.py`` holds one
  device (metrics 1e-4, the winner's params 1e-5);
- ``score-batch`` over a data mesh: predictions of an f32 bundle 1e-5
  (``PRED_TOL``), drift 1e-5, flags equal off the threshold band;
- the launch contract (``MLOPS_TPU_*``, the launcher's ``RANK`` /
  ``WORLD_SIZE``) and the JAX package's refusal texts, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import HPOConfig as JaxHPOConfig
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.parallel import collectives as jcoll
from mlops_tpu.parallel import distributed as jdist
from mlops_tpu.parallel.bulk import score_dataset as jax_score_dataset
from mlops_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mlops_tpu.parallel.mesh import make_nd_mesh as jax_make_nd_mesh
from mlops_tpu.parallel.sharding import param_shardings as jax_param_shardings
from mlops_tpu.train import hpo as jax_hpo
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.parallel import distributed
from mlops_tpu_torch.parallel.bulk import mesh_chunk_rows
from mlops_tpu_torch.parallel.mesh import mesh_shape_for
from mlops_tpu_torch.parallel.sharding import PARAM_RULES, param_shardings, spec_for
from mlops_tpu_torch.weights import exact_params_from_numpy
from torch_dist import run_group
from torch_hpo_seams import split
from torch_students import DRIFT_ATOL, PRED_TOL, assert_flags_match

TOL = 1e-6
METRIC_TOL, PARAM_TOL = 1e-4, 1e-5
TUNE_MODEL = dict(family="mlp", hidden_dims=(16, 16), embed_dim=4, precision="f32", dropout=0.0)
TUNE_TRAIN = dict(batch_size=32)
TUNE_HPO = dict(trials=3, steps=8, eta=2, sha_rungs=2)
SHA_TRIALS = 5
SCORE_ROWS, SCORE_CHUNK = 1000, 301


def _mesh(n: int, axes=None):
    return jax_make_nd_mesh(axes or {"data": n}, devices=jax.devices()[:n])


def _jax_seams(hpo_kw: dict, trials: int, sha: bool, horizon: int, n_rows: int) -> dict:
    """The JAX sweep's per-trial init and the batch indices of every
    (trial, step), for ``trials`` keys of ``split(PRNGKey(seed))``."""
    model = jax_build_model(JaxModelConfig(**TUNE_MODEL))
    keys = jax.random.split(jax.random.PRNGKey(hpo_kw.get("seed", 2024)), trials)
    dummy = (jnp.zeros((2, 9), jnp.int32), jnp.zeros((2, 14), jnp.float32))
    draw = jax.jit(jax.vmap(
        lambda key, step: jax.random.randint(
            jax.random.split(jax.random.fold_in(key, step))[0], (TUNE_TRAIN["batch_size"],),
            0, n_rows),
        in_axes=(None, 0)))
    init, table = [], []
    for key in keys:
        init_key, loop_key = (key, key) if sha else jax.random.split(key)
        params = model.init({"params": init_key}, *dummy, train=False)["params"]
        init.append({k: v.numpy() for k, v in exact_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), "cpu").items()})
        table.append(np.asarray(draw(loop_key, jnp.arange(horizon))))
    return {"init": init, "indices": np.stack(table)}


@pytest.fixture(scope="module")
def data():
    return split()


@pytest.fixture(scope="module")
def score_case(tmp_path_factory):
    from mlops_tpu.data import generate_synthetic
    from torch_ring import MODEL, make_bundle

    root = tmp_path_factory.mktemp("score")
    bundle = make_bundle(root, model=dict(MODEL, precision="f32"), quant=False)
    columns, _ = generate_synthetic(SCORE_ROWS, seed=11, drift=0.3)
    ds = jax_load_bundle(bundle).preprocessor.encode(columns)
    return bundle, ds


@pytest.fixture(scope="module")
def group(tmp_path_factory, data, score_case):
    """One group of 4 gloo ranks running this file's jobs."""
    _, (ptrain, pvalid) = data
    rng = np.random.default_rng(0)
    seams = {}
    for n in (2, 4):
        t_run = -(-TUNE_HPO["trials"] // n) * n
        seams[(n, "random")] = _jax_seams(TUNE_HPO, t_run, False, TUNE_HPO["steps"], ptrain.n)
        counts_steps = jax_hpo_sha_horizon()
        if n == 4:
            seams[(n, "sha")] = _jax_seams(TUNE_HPO, SHA_TRIALS, True, counts_steps, ptrain.n)
    bundle, ds = score_case
    inputs = {
        "x": rng.normal(size=(8, 3)).astype(np.float32),
        "w": rng.normal(size=(8, 3)).astype(np.float32),
        "train_ds": (ptrain.cat_ids, ptrain.numeric, ptrain.labels),
        "valid_ds": (pvalid.cat_ids, pvalid.numeric, pvalid.labels),
        "tune_model": TUNE_MODEL, "tune_train": {**TUNE_TRAIN, "device": "cpu"},
        "tune_hpo": {**TUNE_HPO}, "tune_seams": seams,
        "score_bundle": str(bundle), "score_ds": (ds.cat_ids, ds.numeric, None),
        "score_chunk": SCORE_CHUNK,
    }
    # SHA runs SHA_TRIALS trials; the job reads the trial count per strategy.
    inputs["tune_hpo_sha_trials"] = SHA_TRIALS
    inputs["scorer_params"] = seams[(2, "random")]["init"][0]
    inputs["scorer_rows"] = (ptrain.cat_ids[:8], ptrain.numeric[:8])
    return inputs, run_group(4, ["collectives", "batch_scorer", "tune_mesh", "score_mesh"],
                             inputs, tmp_path_factory.mktemp("group"))


def jax_hpo_sha_horizon() -> int:
    from mlops_tpu_torch.config import HPOConfig
    from mlops_tpu_torch.train.hpo import sha_plan

    return sha_plan(HPOConfig(**{**TUNE_HPO, "trials": SHA_TRIALS}))[2]


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("n", [2, 4])
def test_the_collectives_and_their_gradients_match_shard_map(group, n):
    inputs, results = group
    got = results["collectives"][n]
    mesh = _mesh(n)
    x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])
    mean_fn = jcoll.pmean_over_data(lambda s: (s * s).sum(), mesh)
    rows_fn = jcoll.all_gather_rows(mesh)
    shift_fn = jcoll.ring_shift(mesh)
    np.testing.assert_allclose(got["pmean"], float(mean_fn(x)), rtol=TOL)
    np.testing.assert_allclose(got["pmean_grad"], jax.grad(mean_fn)(x), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["rows"], np.asarray(rows_fn(x)))
    np.testing.assert_allclose(
        got["rows_grad"], jax.grad(lambda a: (w * rows_fn(a)).sum())(x), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["shift"], np.asarray(shift_fn(x)))
    np.testing.assert_array_equal(
        got["shift_grad"], np.asarray(jax.grad(lambda a: (w * shift_fn(a)).sum())(x)))


@pytest.mark.parametrize("n", [2, 4])
def test_the_sharded_batch_scorer_matches_the_jax_one(group, n):
    from mlops_tpu.parallel.steps import make_sharded_batch_scorer as jax_scorer

    inputs, results = group
    model = jax_build_model(JaxModelConfig(**TUNE_MODEL))
    variables = jax_init_params(model, jax.random.PRNGKey(0))
    # The port scored the JAX sweep's first init; score the same params.
    params = {k: jnp.asarray(v) for k, v in inputs["scorer_params"].items()}
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables["params"]),
        [params[".".join(str(getattr(k, "key", k)) for k in path)]
         for path, _ in jax.tree_util.tree_flatten_with_path(variables["params"])[0]])
    cat, num = inputs["scorer_rows"]
    want = jax_scorer(model, jax_make_mesh(n, devices=jax.devices()[:n]))(
        {"params": tree}, jnp.asarray(cat), jnp.asarray(num))
    np.testing.assert_allclose(results["batch_scorer"][n], np.asarray(want), rtol=0, atol=TOL)


# ---------------------------------------------------------------- sharding
SHARDING_FAMILIES = {
    "mlp": dict(family="mlp", hidden_dims=(16, 8), embed_dim=4),
    "mlp-uneven": dict(family="mlp", hidden_dims=(6, 6), embed_dim=4),
    "linear": dict(family="linear"),
    "ft_transformer": dict(family="ft_transformer", token_dim=16, depth=2, heads=4),
    "ft-uneven-heads": dict(family="ft_transformer", token_dim=12, depth=1, heads=3),
    "bert": dict(family="bert", token_dim=16, depth=2, heads=4),
    "moe": dict(family="moe", token_dim=16, depth=1, heads=4, num_experts=4),
    "moe-3-experts": dict(family="moe", token_dim=16, depth=1, heads=2, num_experts=3),
    "mlp-ens4": dict(family="mlp", hidden_dims=(16, 8), embed_dim=4, ensemble_size=4),
    "ft-ens2": dict(family="ft_transformer", token_dim=16, depth=1, heads=4, ensemble_size=2),
    "moe-ens4": dict(family="moe", token_dim=16, depth=1, heads=4, num_experts=4,
                     ensemble_size=4),
}


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("name", sorted(SHARDING_FAMILIES))
def test_param_shardings_match_the_jax_rules(name, mp):
    kw = SHARDING_FAMILIES[name]
    model = jax_build_model(JaxModelConfig(**kw))
    # Shapes are all the rules read.
    params = jax.eval_shape(lambda: jax_init_params(model, jax.random.PRNGKey(0)))["params"]
    mesh = jax_make_mesh(8, model_parallel=mp)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            jax_param_shardings(mesh, params))[0]:
        name_ = ".".join(str(getattr(k, "key", k)) for k in path)
        want[name_] = tuple(sharding.spec)
    port = build_model(ModelConfig(**kw)).state_dict()
    got = param_shardings({"data": 8 // mp, "model": mp}, port)
    assert got == want


def test_a_spec_is_cut_from_the_right_and_padded_on_the_left():
    sizes = {"data": 1, "model": 2}
    # The MoE rule cut to a 2-d bias; an ensemble's extra leading axis.
    assert spec_for("block_0.MoEFeedForward_0.experts_in_bias", (4, 8), sizes) == ("model", None)
    assert spec_for("member.dense_0a.kernel", (4, 8, 16), sizes) == (None, None, "model")
    assert spec_for("stem.kernel", (8, 16), sizes) == (None, None)
    assert spec_for("head.kernel", (8, 1), sizes) == ()
    assert spec_for("dense_0a.kernel", (8, 5), sizes) == (None, None)
    assert [pattern for pattern, _ in PARAM_RULES][0] == r"dense_\d+a\.kernel"
    assert mesh_shape_for(8, 2) == (4, 2)
    with pytest.raises(ValueError, match="not divisible by model_parallel=3"):
        mesh_shape_for(8, 3)


# ------------------------------------------------------------- data mesh
@pytest.mark.parametrize("n,strategy", [(2, "random"), (4, "random"), (4, "sha")])
def test_tune_over_a_data_mesh_matches_the_jax_sweep(group, data, n, strategy):
    (jtrain, jvalid), _ = data
    _, results = group
    got = results["tune_mesh"][(n, strategy)]
    trials = SHA_TRIALS if strategy == "sha" else TUNE_HPO["trials"]
    want = jax_hpo.run_hpo(
        JaxModelConfig(**TUNE_MODEL), JaxTrainConfig(**TUNE_TRAIN),
        JaxHPOConfig(**{**TUNE_HPO, "trials": trials}, strategy=strategy), jtrain, jvalid,
        mesh=jax_make_mesh(n, devices=jax.devices()[:n]),
    )
    assert got["best_index"] == want.best_index
    assert got["best_hyperparams"] == want.best_hyperparams
    assert len(got["trials"]) == len(want.trials) == trials
    for g, w in zip(got["trials"], want.trials):
        assert {k: v for k, v in g.items() if k != "metrics"} == {
            k: v for k, v in w.items() if k != "metrics"}
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= METRIC_TOL, (k, g["metrics"][k], v)
    jp = exact_params_from_numpy(jax.tree_util.tree_map(np.asarray, want.best_params), "cpu")
    assert set(jp) == set(got["best_params"])
    for k, w in jp.items():
        np.testing.assert_allclose(got["best_params"][k], w.numpy(), rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_score_batch_over_a_data_mesh_matches_the_jax_scorer(group, score_case, n):
    bundle, ds = score_case
    _, results = group
    got = results["score_mesh"][n]
    jbundle = jax_load_bundle(bundle)
    want = jax_score_dataset(jbundle, ds, mesh=jax_make_mesh(n, devices=jax.devices()[:n]),
                             chunk_rows=SCORE_CHUNK, exact=True)
    assert mesh_chunk_rows(SCORE_CHUNK, type("M", (), {"shape": {"data": n}})()) == \
        -(-SCORE_CHUNK // n) * n
    np.testing.assert_allclose(got["predictions"], want.predictions, rtol=0, atol=PRED_TOL["f32"])
    assert_flags_match(got["outliers"], want.outliers, ds.numeric, jbundle.monitor.to_arrays())
    for k, v in want.feature_drift.items():
        assert abs(got["drift"][k] - v) <= DRIFT_ATOL, k


def test_the_data_mesh_takes_the_jax_chunk_rule():
    class Mesh:
        shape = {"data": 4}

    assert mesh_chunk_rows(10, None) == 10
    assert mesh_chunk_rows(0, None) == 1
    assert mesh_chunk_rows(10, Mesh()) == 12
    assert mesh_chunk_rows(1, Mesh()) == 4


# ----------------------------------------------------- the launch contract
def test_the_launch_contract_reads_the_jax_variables_and_the_launchers(monkeypatch):
    for var in ("MLOPS_TPU_COORDINATOR", "MLOPS_TPU_PROCESS_ID", "MLOPS_TPU_NUM_PROCESSES",
                "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.multihost_env() is None
    assert distributed.world_size() == 1 and distributed.is_coordinator()
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    env = distributed.multihost_env()
    assert env["init_method"] == "env://" and (env["rank"], env["world_size"], env["local_rank"]) \
        == (3, 4, 1)
    assert not distributed.is_coordinator()
    monkeypatch.setenv("MLOPS_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("MLOPS_TPU_PROCESS_ID", "2")
    monkeypatch.setenv("MLOPS_TPU_NUM_PROCESSES", "8")
    env = distributed.multihost_env()
    assert env["init_method"] == "tcp://10.0.0.1:1234" and (env["rank"], env["world_size"]) \
        == (2, 8)


def test_a_coordinator_without_a_process_count_fails_fast_with_the_jax_text(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MLOPS_TPU_NUM_PROCESSES", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MLOPS_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError) as want:
        jdist.initialize()
    with pytest.raises(ValueError) as got:
        distributed.initialize("cpu")
    assert str(got.value) == str(want.value)


def test_the_card_is_asked_for_and_never_replaced(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MLOPS_TPU_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device("cuda")
    assert distributed.rank_device("cpu").type == "cpu"


def test_the_jax_layout_knob_refusal_is_the_jax_text(tmp_path):
    import mlops_tpu.train.pipeline as jax_pipeline
    from mlops_tpu.config import load_config as jax_load_config
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    args = ["model.family=bert", "model.pipeline_stages=2", "model.tensor_parallel=2",
            f"registry.run_root={tmp_path}", "train.device=cpu"]
    with pytest.raises(ValueError) as want:
        jax_pipeline.run_layout_training(jax_load_config(overrides=args[:-1], env={}))
    with pytest.raises(ValueError) as got:
        run_layout_training(load_config(args))
    assert str(got.value) == str(want.value)


def test_model_shards_is_refused_naming_a11b():
    """The knob loads (sharded serving is ported); only the closed loop
    over a sharded engine is refused, naming A11c."""
    from mlops_tpu_torch.config import load_config

    assert load_config(["serve.model_shards=2"]).serve.model_shards == 2
    with pytest.raises(ValueError, match=r"ROADMAP A11c"):
        load_config(["serve.model_shards=2", "lifecycle.enabled=true"])
