"""The ring plane's shared-memory transport (``serve/ipc.py``) in this
process, on the CPU: slot accounting across a front end's crash, the
engine's re-attach and replay, the incarnation guard, duplicate
completions, the mirrored counters across a respawn, and the fork guard.

Nothing here forks: the plane's processes are stood in for by a
``RingClient`` and a ``RingService`` over one ``RequestRing`` (the
pytest process has JAX's threads, so a fork from it is unsafe; the
forked plane is ``test_torch_frontend.py``'s, in subprocesses). The
replay is held bitwise against the port's own answer: the slab holds the
whole encoded request and the packed programs are pure.
"""

import asyncio
import json
import subprocess
import sys
import threading

import numpy as np
import pytest

from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.engine import InferenceEngine
from mlops_tpu_torch.serve.ipc import LARGE, SMALL, Doorbell, RequestRing, RingClient, RingService
from mlops_tpu_torch.serve.metrics import (
    ENG_INCARNATION,
    ENG_ROWS_LOST,
    MON_ROWS,
    render_ring_metrics,
)
from mlops_tpu_torch.serve.wire import RESP_OK, encode_response
from torch_ring import ROOT, budget, make_bundle, records  # noqa: F401


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("ring"))


def _engine(bundle_dir):
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8, 64), device="cpu",
                             tier_routing=True)
    engine.warmup()
    return engine


def _ring():
    return RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8)


def _zeros(n=1):
    return (np.zeros((n, SCHEMA.num_categorical), np.int32),
            np.zeros((n, SCHEMA.num_numeric), np.float32))


def test_the_doorbell_counts_credit():
    bell = Doorbell()
    try:
        assert bell.drain() == 0
        bell.ring(2)
        bell.ring()
        assert bell.wait(timeout_s=1.0) == 3
        assert bell.wait(timeout_s=0.01) == 0
    finally:
        bell.close()


def test_abandon_after_zombie_release_is_a_noop():
    """The completion lands while ``wait_for`` cancels the future: the
    zombie path releases the slot, and the late ``abandon`` must not
    release it again (two requests on one slab)."""
    async def scenario():
        ring = _ring()
        try:
            client = RingClient(ring, 0)
            slot = client.claim(1)
            future = client.submit(slot, *_zeros())
            future.cancel()
            gen = int(ring.slot_gen[slot])
            ring.resp_status[slot] = RESP_OK
            ring.resp_gen[slot] = gen
            ring.push_completion(slot, gen)
            ring.worker_doorbells[0].ring(1)
            client.on_doorbell()
            free = sum(len(f) for f in client._free)
            assert int(ring.inflight.sum()) == 0
            client.abandon(slot)
            assert sum(len(f) for f in client._free) == free, "double free"
            assert int(ring.inflight.sum()) == 0, "gauge underflow"
        finally:
            ring.close()

    asyncio.run(scenario())


def test_respawned_client_counts_quarantined_slots_as_inflight():
    """A respawned front end quarantines the slot its dead incarnation
    left busy, counts it in the depth gauge, zeroes the parked gauge, and
    seeds its credit with the completion its predecessor's doorbell took."""
    ring = _ring()
    try:
        small, _ = ring.worker_slots(0)
        busy = small[0]
        ring.slot_busy[busy] = 1
        ring.parked[0] = 3
        ring.push_completion(busy, int(ring.slot_gen[busy]))
        ring.worker_doorbells[0].ring(1)
        ring.worker_doorbells[0].drain()  # the credit died with the worker
        client = RingClient(ring, 0)
        assert int(ring.inflight[0, 0, SMALL]) == 1 and int(ring.inflight[0, 0, LARGE]) == 0
        assert int(ring.parked[0]) == 0
        assert client._credit == [1]  # one cell per replica queue
        assert client.claim(1) != busy  # quarantined: not claimable
        client.on_doorbell()
        assert busy in client._free[SMALL]
        assert int(ring.slot_busy[busy]) == 0
    finally:
        ring.close()


def test_engine_reattach_replays_a_busy_slot_bit_identically(bundle_dir):
    """A slot the dead engine popped and never answered (busy, no longer
    queued) is replayed by the next engine's re-attach; the answer is the
    single-process answer to the byte."""
    engine = _engine(bundle_dir)
    recs = records(5, seed=3, drift=0.3)
    want = engine.predict_records_wire(recs)

    async def scenario():
        ring = RequestRing(workers=1, slots_small=2, slots_large=1, large_rows=8)
        try:
            client = RingClient(ring, 0)
            ds = engine.bundle.preprocessor.encode(records_to_columns(recs))
            slot = client.claim(len(recs))
            future = client.submit(slot, ds.cat_ids, ds.numeric)
            assert [s for s, _ in ring.pop_submissions()] == [slot]  # then the kill
            service = RingService(_engine(bundle_dir), ring, max_inflight=2, threads=2)
            try:
                stats = service.reattach()
            finally:
                service.stop()
            assert stats["incarnation"] == 1
            assert stats["replayed_slots"] == 1 and stats["replay_rows"] == len(recs)
            client.on_doorbell()
            assert future.done() and future.result() == RESP_OK
            got = encode_response(*client.response_arrays(slot))
            client.release(slot)
            assert got == want
            assert int(ring.slot_busy.sum()) == 0
        finally:
            ring.close()

    asyncio.run(scenario())


def test_dead_incarnation_completion_is_dropped_not_double_served():
    async def scenario():
        ring = _ring()
        try:
            ring.eng_vals[0, ENG_INCARNATION] = 1
            client = RingClient(ring, 0)
            slot = client.claim(1)
            future = client.submit(slot, *_zeros())
            gen = int(ring.slot_gen[slot])
            # Incarnation 1 answered and queued the completion, then died;
            # its successor bumped the word.
            ring.resp_status[slot] = RESP_OK
            ring.resp_incarnation[slot] = 1
            ring.resp_gen[slot] = gen
            ring.push_completion(slot, gen)
            ring.eng_vals[0, ENG_INCARNATION] = 2
            ring.worker_doorbells[0].ring(1)
            client.on_doorbell()
            assert not future.done(), "a dead incarnation's completion was served"
            ring.resp_incarnation[slot] = 2  # the replay re-answers
            ring.push_completion(slot, gen)
            ring.worker_doorbells[0].ring(1)
            client.on_doorbell()
            assert future.done() and future.result() == RESP_OK
            client.release(slot)
            assert int(ring.inflight.sum()) == 0
        finally:
            ring.close()

    asyncio.run(scenario())


def test_duplicate_completion_across_respawn_is_not_double_released():
    async def scenario():
        ring = _ring()
        try:
            client = RingClient(ring, 0)
            slot = client.claim(1)
            future = client.submit(slot, *_zeros())
            gen = int(ring.slot_gen[slot])
            ring.resp_status[slot] = RESP_OK
            ring.resp_gen[slot] = gen
            ring.push_completion(slot, gen)
            ring.push_completion(slot, gen)  # the replay's duplicate
            ring.worker_doorbells[0].ring(2)
            client.on_doorbell()
            assert future.done() and future.result() == RESP_OK
            free = sum(len(f) for f in client._free)
            assert int(ring.inflight.sum()) == 1, "the handler still holds the slot"
            client.release(slot)
            assert sum(len(f) for f in client._free) == free + 1
            assert int(ring.inflight.sum()) == 0
        finally:
            ring.close()

    asyncio.run(scenario())


def test_an_expired_descriptor_completes_unscored(bundle_dir):
    """A slot whose deadline passed in the queue completes RESP_EXPIRED
    without a dispatch, and counts in the deadline series."""
    from mlops_tpu_torch.serve.wire import RESP_EXPIRED

    engine = _engine(bundle_dir)

    async def scenario():
        ring = _ring()
        try:
            client = RingClient(ring, 0)
            slot = client.claim(1)
            future = client.submit(slot, *_zeros(), deadline=1.0)  # long past
            service = RingService(engine, ring, max_inflight=2, threads=2)
            service.start()
            try:
                await asyncio.wait_for(_until(future, client), 10)
            finally:
                service.stop()
            assert future.result() == RESP_EXPIRED
            assert engine.dispatch_counts() == {}
            assert "mlops_tpu_deadline_expired_total 1" in render_ring_metrics(ring)
        finally:
            ring.close()

    asyncio.run(scenario())


async def _until(future, client):
    while not future.done():
        client.on_doorbell()
        await asyncio.sleep(0.01)


def test_the_mirrored_counters_and_monitor_stay_monotone_across_a_respawn(bundle_dir):
    """Dispatches, tier counts and the monitor aggregate are mirrored into
    shared memory by the engine process; a respawned engine starts its own
    counts at zero and its mirror adds the predecessor's, the monitor
    totals are seeded from the shared aggregate, and the rows the dead
    engine folded unfetched are counted lost."""
    recs = records(3, seed=5)

    async def one_request(ring, client, engine_ds):
        slot = client.claim(len(recs))
        future = client.submit(slot, engine_ds.cat_ids, engine_ds.numeric)
        await asyncio.wait_for(_until(future, client), 10)
        client.release(slot)

    async def scenario():
        ring = _ring()
        try:
            client = RingClient(ring, 0)
            first = _engine(bundle_dir)
            ds = first.bundle.preprocessor.encode(records_to_columns(recs))
            service = RingService(first, ring, max_inflight=2, threads=2,
                                  monitor_fetch_every_s=0)
            service.reattach()
            service.start()
            await one_request(ring, client, ds)
            ring.write_monitor(first.monitor_snapshot())  # a telemetry tick
            await one_request(ring, client, ds)  # folded, never fetched
            service._stop.set()  # the kill: nothing more runs or is written
            service._collector.join()  # else its select could take the next credit
            service._pool.shutdown(wait=True)
            assert ring.dispatch_counts() == {"bucket_8": 2}
            assert int(ring.mon_vals[0, 0, MON_ROWS]) == 3
            second = _engine(bundle_dir)
            service = RingService(second, ring, max_inflight=2, threads=2,
                                  monitor_fetch_every_s=0)
            stats = service.reattach()
            assert stats["monitor_rows_lost"] == 3.0
            assert float(ring.eng_vals[0, ENG_ROWS_LOST]) == 3.0
            service.start()
            try:
                await one_request(ring, client, ds)
            finally:
                service.stop()  # writes the final aggregate
            assert ring.dispatch_counts() == {"bucket_8": 3}
            assert second.dispatch_counts() == {"bucket_8": 1}
            assert int(ring.mon_vals[0, 0, MON_ROWS]) == 6  # 3 fetched + 3 new: monotone
            text = render_ring_metrics(ring)
            assert 'mlops_tpu_tier_requests_total{tier="exact"} 3' in text
            assert "mlops_tpu_engine_incarnation 2" in text
        finally:
            ring.close()

    asyncio.run(scenario())


def test_a_fork_with_a_thread_running_is_refused():
    from mlops_tpu_torch.serve.frontend import _check_fork_safe

    stop = threading.Event()
    thread = threading.Thread(target=stop.wait)
    thread.start()
    try:
        with pytest.raises(RuntimeError, match="refusing to fork"):
            _check_fork_safe()
    finally:
        stop.set()
        thread.join()


def test_the_supervisor_and_the_front_ends_load_no_torch():
    """The modules the supervisor and the front ends run, the CLI's
    bundle resolution among them, import neither torch nor JAX: only the
    engine child touches a device."""
    code = (
        "import json, sys\n"
        "import mlops_tpu_torch.cli, mlops_tpu_torch.serve.frontend\n"
        "import mlops_tpu_torch.data.encode, mlops_tpu_torch.bundle.registry\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'mlops_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
