"""Sharded serving (``serve.model_shards = 2``) on both serving planes, on
the CPU (gloo ranks), each booted as a subprocess (``tests/torch_ring.py``):

- the single-process plane: ``serve serve.model_shards=2`` starts one
  follower rank; its answers to ``POST /predict`` are held against the
  port's unsharded engine on the same bundle (predictions 1e-6 beside
  the bf16 ``PRED`` tolerance of the row cuts: 1.6e-2; drift 1e-5;
  flags as the JAX tests compare them, exact off the threshold band),
  and SIGTERM ends both ranks with exit 0;
- the ring plane: one replica of two ranks answers the same; ``kill -9``
  of its follower ends the replica, the supervisor respawns it (the
  engine's incarnation goes to 2) and the respawned replica answers
  byte for byte as before;
- ``_replica_config``: replica r takes cards ``[r*S, (r+1)*S)``, and a
  process that sees too few cards is refused, naming the count.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.config import load_config
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve import frontend
from mlops_tpu_torch.serve.engine import InferenceEngine
from torch_ring import BUCKETS, Plane, budget, exchange, make_bundle, records  # noqa: F401

PRED_ATOL = 1.6e-2 + 1e-6  # bf16 row cuts against the unsharded product
DRIFT_ATOL = 1e-5 + 1e-6
FLAG_BAND = 1e-5


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("shard_plane"), seed=3, quant=False)


@pytest.fixture(scope="module")
def bodies_and_wants(bundle_dir):
    """Request bodies, the unsharded engine's answers and the rows whose
    outlier flag is off the threshold band."""
    bundle = load_bundle(bundle_dir)
    engine = InferenceEngine(bundle, buckets=tuple(int(b) for b in BUCKETS.split(",")),
                             device="cpu")
    mon = bundle.monitor
    out = []
    for n in (1, 5, 40):
        recs = records(n, seed=60 + n, drift=0.2)
        num = bundle.preprocessor.encode(records_to_columns(recs)).numeric.astype(np.float64)
        diff = num - mon.out_mean.double().numpy()
        d2 = np.einsum("ni,ij,nj->n", diff, mon.out_precision.double().numpy(), diff)
        thr = float(mon.out_threshold)
        out.append((json.dumps(recs).encode(), engine.predict_records(recs),
                    np.abs(d2 - thr) > FLAG_BAND * abs(thr)))
    return out


def _check(port, bodies_and_wants):
    answers = []
    for body, want, off in bodies_and_wants:
        status, _, payload = exchange(port, "POST", "/predict", body)
        assert status == 200, payload[:300]
        got = json.loads(payload)
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   atol=PRED_ATOL, rtol=0)
        np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                                   list(want["feature_drift_batch"].values()),
                                   atol=DRIFT_ATOL, rtol=0)
        np.testing.assert_array_equal(np.asarray(got["outliers"])[off],
                                      np.asarray(want["outliers"])[off])
        answers.append(payload)
    return answers


def _followers(plane):
    """The follower pids the lead logged (the latest start)."""
    lines = [line for line in plane.text().splitlines()
             if line.startswith("sharded engine: rank 0 of 2")]
    assert lines, plane.text()[-3000:]
    return json.loads(lines[-1].split("followers ", 1)[1])


def test_the_single_process_plane_serves_over_two_ranks(bundle_dir, bodies_and_wants,
                                                        tmp_path):
    plane = Plane(bundle_dir, tmp_path / "single.log", ("serve.model_shards=2",))
    try:
        (follower,) = _followers(plane)
        _check(plane.port, bodies_and_wants)
    finally:
        assert plane.stop() == 0
    text = plane.text()
    assert "follower rank 1 on cpu ran" in text, text[-3000:]
    with pytest.raises(ProcessLookupError):
        os.kill(follower, 0)


def test_a_ring_replica_is_its_ranks_and_respawns_whole(bundle_dir, bodies_and_wants,
                                                        tmp_path):
    plane = Plane(bundle_dir, tmp_path / "ring.log",
                  ("serve.workers=2", "serve.model_shards=2"))
    try:
        before = _check(plane.port, bodies_and_wants)
        (follower,) = _followers(plane)
        os.kill(follower, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while len([line for line in plane.text().splitlines()
                   if line.startswith("warmup complete; ready {")]) < 2:
            assert time.monotonic() < deadline, plane.text()[-3000:]
            time.sleep(0.1)
        assert _followers(plane) != [follower]
        after = _check(plane.port, bodies_and_wants)
        assert after == before
        assert plane.metric("mlops_tpu_engine_incarnation") == 2
        assert "follower rank 1 (pid" in plane.text()
    finally:
        assert plane.stop() == 0


def test_a_replica_takes_its_card_slice_or_is_refused(monkeypatch):
    import torch

    config = load_config(["serve.model_shards=2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert frontend._replica_config(config, 1, 2).serve.device == "cuda:2"
    assert frontend._replica_config(config, 0, 2).serve.device == "cuda:0"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match=r"needs 4 cards .* this process sees 3"):
        frontend._replica_config(config, 0, 2)
    unsharded = load_config([])
    assert frontend._replica_config(unsharded, 1, 2).serve.device == "cuda:1"
