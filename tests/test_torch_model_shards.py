"""Sharded serving (``serve.model_shards = S``) against the JAX package, on
the CPU.

One group of 2 gloo ranks and one of 4 (``tests/torch_dist.py``, the job
``model_shards`` of ``torch_dist_jobs.py``) serve small mlp (f32),
ft_transformer (bf16), bert (bf16) and moe (f32) bundles through the
port's sharded engine: rank 0 dispatches, the others follow. Their
answers are held against the JAX ``InferenceEngine(model_shards=S)`` on
S of the conftest's 8 simulated CPU devices and against the port's
unsharded engine. The 2-rank group also serves each bundle over a
one-rank mesh beside the unsharded engine, which must be bitwise.

Tolerances, per field: predictions f32 1e-5, bf16 1.6e-2 (four bf16 ulps
of a logit below 4 times the sigmoid's slope; the row cuts round partial
products to bf16 before their all-reduce, which the unsharded product
does not), plus 1e-6 for the responses' six places; drift 1e-5 + 1e-6
(chi-squared p-values of two libraries; the monitor is replicated, so
the statistics are the unsharded ones); outlier flags exact except rows
within 1e-5 x threshold of it; accumulator rows, outliers and batches
exact (counts); drift sums 1e-4.
"""

import concurrent.futures
import json
import threading

import jax
import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.models import build_model as jax_build_model
from mlops_tpu.models import init_params as jax_init_params
from mlops_tpu.monitor import state as jstate
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.config import ModelConfig, load_config
from mlops_tpu_torch.data import Preprocessor
from mlops_tpu_torch.models import build_model
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.weights import exact_params_from_numpy, load_params, monitor_from_numpy
from torch_dist import run_group
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

TEMPERATURE = 1.37
PRED_TOL = {"f32": 1e-5 + 1e-6, "bf16": 1.6e-2 + 1e-6}
DRIFT_ATOL = 1e-5 + 1e-6
DRIFT_SUM_ATOL = 1e-4
FLAG_BAND = 1e-5
BUCKETS = (1, 8, 64, 256)
SOLO_ROWS = (1, 5, 64, 200)  # one request per bucket
GROUP_SIZES = (3,) * 10  # ten requests of 3 rows: the 16 x 8 geometry
# The solo requests the JAX engine answers at each S (every one at 2; at 4
# buckets 8 and 256, to keep its compiles in the suite's clock). The
# port's sharded engine answers every one at both, held against its
# unsharded engine at each.
JAX_SOLO = {2: (0, 1, 2, 3), 4: (1, 3)}

FAMILIES = {
    "mlp": dict(family="mlp", hidden_dims=(32, 32, 16), embed_dim=4, precision="f32"),
    "ft_transformer": dict(family="ft_transformer", token_dim=16, depth=2, heads=4,
                           precision="bf16"),
    "bert": dict(family="bert", token_dim=16, depth=2, heads=4, precision="bf16"),
    "moe": dict(family="moe", token_dim=16, depth=1, heads=4, num_experts=4,
                precision="f32"),
}


def _jax_params(kw, seed):
    """The flax init of the config, plus seeded noise on every leaf."""
    model = jax_build_model(JaxModelConfig(**kw))
    params = jax.jit(lambda key: jax_init_params(model, key))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32),
        params["params"],
    )


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    columns, _ = jax_synthetic(3000, seed=0)
    prep = JaxPreprocessor.fit(columns)
    monitor = jstate.fit_monitor(prep.encode(columns))
    path = tmp_path_factory.mktemp("prep") / "preprocess.npz"
    prep.save(path)
    return prep, Preprocessor.load(path), monitor_from_numpy(monitor.to_arrays(), "cpu")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory, fitted):
    """A port-written bundle per family (seeded weights), the mlp again
    with a gated quant tier, and the gbm fixture's bundle."""
    import sys

    from torch_dist import ROOT

    _, prep, monitor = fitted
    root = tmp_path_factory.mktemp("shard_bundles")
    out = {}
    for family, kw in FAMILIES.items():
        model = build_model(ModelConfig(**kw))
        load_params(model, exact_params_from_numpy(_jax_params(kw, seed=7), "cpu"))
        out[family] = save_exact_bundle(root / family, ModelConfig(**kw), model.eval(), prep,
                                        monitor, calibration={"temperature": TEMPERATURE})
    kw = FAMILIES["mlp"]
    model = build_model(ModelConfig(**kw))
    load_params(model, exact_params_from_numpy(_jax_params(kw, seed=8), "cpu"))
    out["quant"] = save_exact_bundle(
        root / "quant", ModelConfig(**kw), model.eval(), prep, monitor,
        calibration={"temperature": TEMPERATURE},
        quant_params=quantize_student(init_quant_master(0)),
        quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}})
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from torch_gbm_fixture import fixture_bundle
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    out["gbm"] = fixture_bundle(root / "gbm")
    return {k: str(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def requests(fitted):
    """Encoded requests: one per bucket and one group of ten."""
    prep = fitted[0]
    solo = []
    for i, n in enumerate(SOLO_ROWS):
        columns, _ = jax_synthetic(n, seed=40 + i, drift=0.3)
        ds = prep.encode(columns)
        solo.append((ds.cat_ids, ds.numeric.astype(np.float32)))
    columns, _ = jax_synthetic(sum(GROUP_SIZES), seed=50)
    ds = prep.encode(columns)
    bounds = np.cumsum([0, *GROUP_SIZES])
    parts = [(ds.cat_ids[lo:hi], ds.numeric[lo:hi].astype(np.float32))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    return {"solo": solo, "groups": [parts]}


def _group(world, bundles, requests, workdir):
    inputs = {"bundles": {f: bundles[f] for f in FAMILIES}, "quant_bundle": bundles["quant"],
              "gbm_bundle": bundles["gbm"], "buckets": BUCKETS, "one_rank": world == 2,
              **requests}
    return run_group(world, ["model_shards"], inputs, workdir)["model_shards"]


@pytest.fixture(scope="module")
def runs(bundles, requests, tmp_path_factory):
    """ONE group of each size runs every case, in a thread, while this
    process computes the references (``_references``). Returns ``(groups,
    references)``: per world size rank 0's results and the followers'
    states."""
    groups, failed = {}, []

    def run():
        try:
            for world in (2, 4):
                workdir = tmp_path_factory.mktemp(f"shards{world}")
                result = _group(world, bundles, requests, workdir)
                groups[world] = (result, [
                    json.loads((workdir / f"follower{r}.json").read_text())
                    for r in range(1, world)])
        except BaseException as err:  # raised in the test thread below
            failed.append(err)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        references = _references(bundles, requests)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return groups, references


@pytest.fixture(scope="module")
def groups(runs):
    return runs[0]


@pytest.fixture(scope="module")
def references(runs):
    return runs[1]


def _references(bundles, requests):
    """The JAX engine's answers at model_shards 2 and 4 and the port's
    unsharded engine's, per family."""
    def family_refs(family):
        out = {}
        for shards in (2, 4):
            engine = JaxEngine(jax_load_bundle(bundles[family]), buckets=BUCKETS,
                               model_shards=shards)
            out["jax", shards, family] = _answers(engine, requests, JAX_SOLO[shards])
        out["port", family] = _answers(
            InferenceEngine(load_bundle(bundles[family]), buckets=BUCKETS, device="cpu"),
            requests)
        return out

    # Two families at a time: XLA compiles outside the GIL.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return {k: v for part in pool.map(family_refs, FAMILIES) for k, v in part.items()}


def _answers(engine, requests, which=None):
    """``engine``'s answers to the solo requests (those of ``which``, by
    index; the others None), the group and the monitor snapshot."""
    solo = [engine.fetch_arrays(engine.dispatch_arrays(cat, num))
            if which is None or i in which else None
            for i, (cat, num) in enumerate(requests["solo"])]
    group = [engine.fetch_group(engine.dispatch_group_arrays(parts))
             for parts in requests["groups"]]
    return {"solo": solo, "group": group, "snapshot": engine.monitor_snapshot()}


def _off_band(monitor, num):
    mean = monitor.out_mean.double().numpy()
    precision = monitor.out_precision.double().numpy()
    diff = num.astype(np.float64) - mean
    d2 = np.einsum("ni,ij,nj->n", diff, precision, diff)
    thr = float(monitor.out_threshold)
    return np.abs(d2 - thr) > FLAG_BAND * abs(thr)


def _assert_response(got, want, num, monitor, pred_tol):
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=pred_tol, rtol=0)
    assert list(got["feature_drift_batch"]) == list(want["feature_drift_batch"])
    np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                               list(want["feature_drift_batch"].values()),
                               atol=DRIFT_ATOL, rtol=0)
    off = _off_band(monitor, num)
    np.testing.assert_array_equal(np.asarray(got["outliers"])[off],
                                  np.asarray(want["outliers"])[off])


def _assert_answers(got, want, requests, monitor, pred_tol):
    for g, w, (_, num) in zip(got["solo"], want["solo"], requests["solo"]):
        if w is not None:
            _assert_response(g, w, num, monitor, pred_tol)
    for g_group, w_group, parts in zip(got["group"], want["group"], requests["groups"]):
        assert len(g_group) == len(w_group) == len(parts)
        for g, w, (_, num) in zip(g_group, w_group, parts):
            _assert_response(g, w, num, monitor, pred_tol)
    if None in want["solo"]:
        return  # the snapshots cover different requests
    for key in ("rows", "outliers", "batches"):
        assert got["snapshot"][key] == want["snapshot"][key], key
    np.testing.assert_allclose(got["snapshot"]["drift_sum"], want["snapshot"]["drift_sum"],
                               atol=DRIFT_SUM_ATOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_sharded_engine_answers_as_the_jax_sharded_engine(
        groups, references, requests, fitted, family, world):
    result, _ = groups[world]
    got = result["families"][family]
    assert got["shards"] == world
    tol = PRED_TOL[FAMILIES[family]["precision"]]
    monitor = fitted[2]
    _assert_answers(got, references["jax", world, family], requests, monitor, tol)
    _assert_answers(got, references["port", family], requests, monitor, tol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_rules_split_each_family_and_replicate_the_state(groups, family, world):
    got = groups[world][0]["families"][family]
    specs, split = got["specs"], got["split"]
    assert split, f"no {family} param split over {world} ranks"
    if family == "moe":
        assert {n for n in split if "experts_" in n} == {
            n for n in specs if "experts_" in n}, "the moe experts are not all split"
    # Rank 0 committed its block of each split param and every other
    # param whole.
    assert set(got["blocks"]) == set(specs)
    for name, (block, full) in got["blocks"].items():
        want = list(full)
        for dim, axis in enumerate(specs[name]):
            if axis == "model":
                want[dim] //= world
        assert block == want, name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_one_rank_mesh_is_bitwise_the_unsharded_engine(groups, family):
    one = groups[2][0]["one_rank"][family]
    plain, sharded = one["plain"], one["sharded"]
    for got, want in zip(sharded["raw"] + sharded["group_raw"],
                         plain["raw"] + plain["group_raw"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert sharded["snapshot"] == plain["snapshot"]
    assert sharded["dispatches"] == plain["dispatches"]


@pytest.mark.parametrize("world", [2, 4])
def test_a_swap_a_rollback_and_a_regrid_run_in_step_on_every_rank(
        groups, references, requests, fitted, world):
    result, followers = groups[world]
    turns = result["turnover"]
    assert (turns["swap_generation"], turns["rollback_generation"]) == (2, 3)
    assert turns["grid_generation"] == 2 and turns["warm"]["graphs"] == 1
    for a, b in zip(turns["rolled_back"], turns["before"]):
        np.testing.assert_array_equal(a, b)
    monitor = fitted[2]
    num = requests["solo"][1][1]
    from mlops_tpu_torch.serve.wire import format_response

    # The swapped-in bert answers as the unsharded bert does.
    _assert_response(format_response(*turns["swapped"]),
                     references["port", "bert"]["solo"][1], num, monitor,
                     PRED_TOL["bf16"])
    # Bucket 3 against bucket 8: the same rows in another batch shape.
    np.testing.assert_allclose(turns["regridded"][0], turns["before"][0][:3],
                               atol=PRED_TOL["f32"], rtol=0)
    assert turns["dispatches"]["bucket_3"] == 1
    snapshot = turns["snapshot"]
    assert snapshot["rows"] == 5 * 3 + 3 and snapshot["batches"] == 4
    # The lead's dropped engines were freed without a collection, and
    # each follower holds the twins of the engines the lead still holds.
    assert result["freed"] and all(result["freed"])
    for state in followers:
        state = state["engines"]
        assert sorted(int(sid) for sid in state) == result["held"]
        live = state[str(result["live_sid"])]
        assert (live["bundle_generation"], live["grid_generation"]) == (4, 2)
        assert live["buckets"] == [1, 3, *BUCKETS[1:]]
        # The replicated accumulator: the followers folded the same rows.
        assert live["window"][:3] == [snapshot["rows"], snapshot["outliers"],
                                      snapshot["batches"]]


@pytest.mark.parametrize("world", [2, 4])
def test_the_ranks_agree_on_each_readied_shape_and_refuse_a_mesh_out_of_step(
        groups, world):
    result, followers = groups[world]
    turns = result["turnover"]
    # Bucket 2 failed on the followers only, after its collectives: the
    # lead raised, no rank counts it ready, and the mesh serves on in step.
    assert turns["failed_ready"] == "readying exact (2,) failed on another rank of the mesh"
    assert 2 not in turns["warmed_solo"] and 3 in turns["warmed_solo"]
    for a, b in zip(turns["after_failure"], turns["regridded"]):
        np.testing.assert_array_equal(a, b)
    for state in followers:
        assert state["engines"][str(result["live_sid"])]["warmed_solo"] == \
            turns["warmed_solo"]
        assert state["out_of_step"]
    assert result["out_of_step"] and result["announce_refused"]


@pytest.mark.parametrize("world", [2, 4])
def test_the_quant_tier_is_refused_under_sharding_with_the_jax_message(
        groups, bundles, world):
    result, _ = groups[world]
    jax_bundle = jax_load_bundle(bundles["quant"])
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_bundle, buckets=(1,), serve_tier="quant", model_shards=world)
    assert result["quant"] == str(want.value)
    assert "quant tier is single-device; model_shards > 1 shards the exact params only" \
        in result["quant"]
    jax_auto = JaxEngine(jax_bundle, buckets=(1,), serve_tier="auto", model_shards=world,
                         tier_routing=True)
    assert result["auto"] == {"tier": jax_auto.serve_tier, "tiers": ["exact"]}


@pytest.mark.parametrize("world", [2, 4])
def test_a_gbm_bundle_ignores_the_mesh(groups, bundles, requests, world):
    result, _ = groups[world]
    gbm = result["gbm"]
    assert gbm["shards"] == 1 and gbm["tier"] == "gbm"
    plain = InferenceEngine(load_bundle(bundles["gbm"]), buckets=BUCKETS, device="cpu")
    want = _answers(plain, requests)
    assert gbm["solo"] == want["solo"] and gbm["group"] == want["group"]
    # Not an engine of the mesh: the followers never built it.
    assert gbm["built"] == 0


def test_the_knob_loads_and_a_quant_demand_is_refused_in_process(bundles):
    assert load_config(["serve.model_shards=2"]).serve.model_shards == 2
    with pytest.raises(ValueError, match="must be >= 1"):
        load_config(["serve.model_shards=0"]).serve.validate()
