"""The port's hot swap and shadow serving on the CPU, held against the
JAX package's engine on the same tiny JAX-written incumbent
(``tiny_pipeline``: mlp, hidden (32, 32), embed 4, buckets (1, 8)) and a
candidate the port retrains from it.

After ``swap_bundle`` rows answer like the candidate's own engine and,
after ``rollback``, like the incumbent's, bitwise; the generation counter
follows the JAX engine's; the live aggregate counts exactly the rows
served across the swap and never a mirrored or holdout row; a request
routed to a tier the promoted bundle lacks serves on its default tier,
and the rollback brings the tier back; the refusals are the JAX
engine's. Port against JAX answers: the exact tier's bf16 tolerance of
``test_torch_exact.py`` (1.6e-2 on predictions).
"""

import sys
import threading

import numpy as np
import pytest

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.lifecycle.shadow import ShadowEngine as JaxShadow
from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
from mlops_tpu_torch.analysis.lockcheck import instrument_locks
from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
from mlops_tpu_torch.lifecycle.retrain import run_retrain
from mlops_tpu_torch.lifecycle.shadow import ShadowEngine
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.serve.engine import InferenceEngine
from torch_lifecycle import budget, feed, port_config, scenery  # noqa: F401
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

PRED_ATOL = 1.6e-2 + 1e-6


@pytest.fixture(scope="module")
def candidate(scenery):
    config = port_config(scenery["td"], scenery["labeled"])
    return run_retrain(scenery["bundle"], config, generation=2)


def _engine(bundle, **kw):
    engine = InferenceEngine(bundle, buckets=(1, 8), device="cpu", **kw)
    engine.warmup()
    return engine


def _rows(scenery, n=8):
    ds = scenery["drifted"]
    return ds.cat_ids[:n], ds.numeric[:n]


def test_swap_answers_like_the_candidate_and_rolls_back_bitwise(scenery, candidate):
    live = _engine(scenery["bundle"])
    cand = _engine(candidate.bundle)
    cat, num = _rows(scenery)
    inc_answer = live.predict_arrays(cat, num)
    cand_answer = cand.predict_arrays(cat, num)
    assert inc_answer != cand_answer
    generations = [live.swap_bundle(cand)]
    assert live.predict_arrays(cat, num) == cand_answer
    assert live.bundle is candidate.bundle
    generations.append(live.rollback())
    assert live.predict_arrays(cat, num) == inc_answer
    generations.append(live.rollback())  # the states exchange: roll forward
    assert live.predict_arrays(cat, num) == cand_answer
    assert live.swap_stats["op"] == "rollback" and live.swap_stats["critical_us"] >= 0

    # The JAX engine over the same two bundles: the same generations and,
    # within the bf16 tolerance, the same answers.
    jlive = JaxEngine(jax_load_bundle(scenery["bundle_dir"]), buckets=(1, 8),
                      enable_grouping=False)
    jlive.warmup()
    shadow = JaxShadow(jlive, jax_load_bundle(candidate.candidate_dir))
    shadow.warm()
    want = [jlive.swap_bundle(shadow.engine), jlive.rollback(), jlive.rollback()]
    assert generations == want == [2, 3, 4]
    np.testing.assert_allclose(jlive.predict_arrays(cat, num)["predictions"],
                               cand_answer["predictions"], atol=PRED_ATOL, rtol=0)


def test_the_aggregate_counts_every_served_row_once_across_swaps(scenery, candidate):
    live = _engine(scenery["bundle"])
    cand = _engine(candidate.bundle)
    base = live.monitor_snapshot()
    served = feed(live, scenery["normal"])  # still in the device window at the swap
    live.swap_bundle(cand)
    served += feed(live, scenery["drifted"])
    group = [(scenery["drifted"].cat_ids[i:i + 3], scenery["drifted"].numeric[i:i + 3])
             for i in range(0, 12, 3)]
    live.fetch_group(live.dispatch_group_arrays(group))
    served += 12
    feed(cand, scenery["drifted"])  # the candidate engine's own accumulator
    mid = live.monitor_snapshot()
    assert mid["rows"] - base["rows"] == served
    live.rollback()
    served_after = feed(live, scenery["normal"])
    assert live.monitor_snapshot()["rows"] - mid["rows"] == served_after
    batches = live.monitor_snapshot()["batches"] - base["batches"]
    assert batches == 8 + 8 + 4 + 8


def test_mirrored_and_holdout_rows_never_fold_into_the_live_aggregate(scenery, candidate):
    live = _engine(scenery["bundle"])
    before = live.monitor_snapshot()
    shadow = ShadowEngine(live, candidate.bundle)
    shadow.warm()
    assert shadow.warm_mode == "eager"  # the CPU route, on both sides
    cat, num = _rows(scenery)
    for _ in range(5):
        shadow.mirror(cat, num)
    report = shadow.evaluate(candidate.holdout, candidate.holdout_incumbent)
    after = live.monitor_snapshot()
    assert (after["rows"], after["batches"]) == (before["rows"], before["batches"])
    assert report.mirrors == 5 and report.holdout_rows == candidate.holdout.n
    # Both sides by the same route: the incumbent's side is the incumbent
    # engine's own answer, bit for bit, as the candidate's is the candidate's.
    np.testing.assert_array_equal(
        shadow._score_incumbent(cat, num),
        np.asarray(live.predict_arrays(cat, num)["predictions"], np.float64),
    )
    assert report.p99_candidate_ms > 0 and report.p99_incumbent_ms > 0
    assert shadow.engine.monitor_snapshot()["rows"] == 5 * 8 + candidate.holdout.n


def test_concurrent_dispatches_across_a_swap_each_run_one_generation(scenery, candidate):
    live = _engine(scenery["bundle"])
    cand = _engine(candidate.bundle)
    cat, num = _rows(scenery)
    expected = (live.predict_arrays(cat, num), cand.predict_arrays(cat, num))
    base = live.monitor_snapshot()["rows"]
    responses, errors = [], []
    start = threading.Barrier(4)

    def hammer():
        try:
            start.wait()
            for _ in range(30):
                responses.append(live.predict_arrays(cat, num))
        except Exception as err:  # surfaced below
            errors.append(err)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads as finely as it can
    try:
        # The engine's locks instrumented against its declared order, the
        # schedule perturbed (the JAX suite's seed 7).
        with instrument_locks(live, perturb_seed=7) as sanitizer:
            for t in threads:
                t.start()
            start.wait()
            live.swap_bundle(cand)
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert not sanitizer.violations, [str(v) for v in sanitizer.violations]
    assert sanitizer.acquired.get("_acc_lock", 0) >= 90
    matched = [sum(r == e for r in responses) for e in expected]
    assert sum(matched) == len(responses) == 90 and matched[1] > 0
    assert live.monitor_snapshot()["rows"] - base == 90 * 8


@pytest.fixture(scope="module")
def quant_incumbent(scenery, tmp_path_factory):
    """The incumbent with a gated quant student beside its exact model."""
    bundle = scenery["bundle"]
    path = tmp_path_factory.mktemp("quant_incumbent")
    save_exact_bundle(
        path, bundle.model_config, bundle.model, bundle.preprocessor,
        bundle.monitor, calibration=bundle.manifest["calibration"],
        quant_params=quantize_student(init_quant_master(0)),
        quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}},
    )
    return load_bundle(path)


def test_a_promotion_without_a_quant_tier_serves_cheap_requests_on_default(
    quant_incumbent, scenery, candidate
):
    live = _engine(quant_incumbent, tier_routing=True)
    cand = _engine(candidate.bundle, tier_routing=True)
    cat, num = _rows(scenery)
    cheap = live.predict_arrays(cat, num, tier="quant")
    exact = live.predict_arrays(cat, num)
    assert live.available_tiers == ("quant", "exact") and cheap != exact
    live.swap_bundle(cand)
    assert live.available_tiers == ("exact",) and live.route_tier(1) is None
    want = cand.predict_arrays(cat, num)
    assert live.predict_arrays(cat, num, tier="quant") == want  # the default tier
    assert live.dispatch_counts() == {"bucket_8@quant": 1, "bucket_8": 2}
    live.rollback()
    assert live.route_tier(1) == "quant"
    assert live.predict_arrays(cat, num, tier="quant") == cheap
    assert live.predict_arrays(cat, num) == exact
    with pytest.raises(ValueError, match="not committed"):
        live.predict_arrays(cat, num, tier="accurate")


def test_the_tee_sees_each_request_before_padding(scenery):
    live = _engine(scenery["bundle"])
    seen = []
    live.set_lifecycle_tee(lambda cat, num: seen.append((cat.shape, num.shape)))
    cat, num = _rows(scenery, 5)
    live.predict_arrays(cat, num)
    live.dispatch_group_arrays([(cat[:2], num[:2]), (cat[2:5], num[2:5])])
    live.set_lifecycle_tee(None)
    live.predict_arrays(cat, num)
    assert [s[0][0] for s in seen] == [5, 2, 3]


def test_swap_refusals_are_the_jax_engines(scenery, candidate):
    live = _engine(scenery["bundle"])
    with pytest.raises(ValueError, match="no retired bundle"):
        live.rollback()
    small = InferenceEngine(candidate.bundle, buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="may never shrink"):
        live.swap_bundle(small)

    class Hybrid:
        monitor_accumulating = False

    with pytest.raises(ValueError, match="device-accumulating"):
        live.swap_bundle(Hybrid())
    with pytest.raises(ValueError, match="device-accumulating"):
        ShadowEngine(Hybrid(), candidate.bundle)
    assert live.bundle_generation == 1
