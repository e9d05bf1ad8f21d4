"""The port's staged executor (``mlops_tpu_torch.data.pipeline_exec``)
against the JAX package's, on the same pure-Python stages: outputs and
their order equal at every depth, with and without a batch stage; the
same stage record; the original exception out of any position, every
worker joined; backpressure bounds the items in flight."""

import threading
import time

import pytest

from mlops_tpu.data import pipeline_exec as jexec
from mlops_tpu_torch.analysis.lockcheck import SchedulePerturber
from mlops_tpu_torch.data import pipeline_exec as texec

DEPTHS = (1, 2, 3)


def _stages(mod, batch: bool):
    stages = [mod.Stage("sq", lambda x: x * x)]
    if batch:
        stages.append(mod.Stage("neg", lambda xs: [-x for x in xs], batch_max=4))
    else:
        stages.append(mod.Stage("neg", lambda x: -x))
    stages.append(mod.Stage("pair", lambda x: (x, x % 7)))
    return stages


def _run(mod, depth: int, batch: bool, n: int = 200):
    out = []
    stats = mod.run_pipeline(range(n), _stages(mod, batch), out.append, depth=depth)
    return out, stats


@pytest.mark.parametrize("batch", [False, True], ids=["plain", "batch_max"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_outputs_order_and_stage_record_match_the_jax_executor(depth, batch):
    got, stats = _run(texec, depth, batch)
    want, jstats = _run(jexec, depth, batch)
    assert got == want == [(-(x * x), -(x * x) % 7) for x in range(200)]
    assert stats.items == jstats.items == 200
    assert stats.depth == jstats.depth == depth
    assert set(stats.stages) == set(jstats.stages) == {"read", "sq", "neg", "pair", "write"}
    for name, row in stats.stages.items():
        assert set(row) == set(jstats.stages[name]) == {"busy_s", "items", "occupancy"}
        assert row["items"] == jstats.stages[name]["items"]
    assert set(stats.as_dict()) == set(jstats.as_dict()) == {"depth", "wall_s", "items", "stages"}


@pytest.mark.parametrize("depth", DEPTHS)
def test_a_deep_batch_queue_keeps_order_and_items(depth):
    """The bulk fetch stage's shape: a batch stage with its own deep input
    queue (``queue_depth``) behind slow producers."""
    def slow(x):
        time.sleep(0.0002)
        return x

    for mod in (texec, jexec):
        out = []
        stats = mod.run_pipeline(
            range(90),
            [mod.Stage("slow", slow),
             mod.Stage("wave", lambda xs: [x + 1 for x in xs], batch_max=32, queue_depth=32)],
            out.append, depth=depth,
        )
        assert out == list(range(1, 91))
        assert stats.stages["wave"]["items"] == 90


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("where", ["source", "stage", "batch-stage", "sink"])
def test_an_error_in_any_stage_comes_back_out(where, depth):
    class Boom(RuntimeError):
        pass

    def src():
        for i in range(60):
            if where == "source" and i == 10:
                raise Boom("source")
            yield i

    def mid(x):
        if where == "stage" and x == 10:
            raise Boom("stage")
        return x

    def batch(xs):
        if where == "batch-stage" and 10 in xs:
            raise Boom("batch-stage")
        return xs

    def sink(x):
        if where == "sink" and x == 10:
            raise Boom("sink")

    for mod in (texec, jexec):
        # Under the JAX suite's seeded schedule perturbation
        # (analysis/lockcheck.py): each seed shifts which stages are
        # mid-flight when the failure lands.
        for seed in (0, 1, 2):
            perturber = SchedulePerturber(seed, max_delay_s=0.0005)
            before = threading.active_count()
            with pytest.raises(Boom, match=where):
                mod.run_pipeline(
                    src(),
                    [mod.Stage("mid", perturber.wrap(mid)),
                     mod.Stage("batch", perturber.wrap(batch), batch_max=4)],
                    perturber.wrap(sink),
                    depth=depth,
                )
            assert threading.active_count() == before  # every worker joined


def test_backpressure_bounds_the_items_in_flight():
    lock = threading.Lock()
    state = {"produced": 0, "consumed": 0, "max_inflight": 0}

    def produce():
        for i in range(100):
            with lock:
                state["produced"] += 1
                state["max_inflight"] = max(
                    state["max_inflight"], state["produced"] - state["consumed"]
                )
            yield i

    def slow_sink(_):
        time.sleep(0.002)
        with lock:
            state["consumed"] += 1

    depth = 2
    stages = [texec.Stage("a", lambda x: x), texec.Stage("b", lambda x: x)]
    texec.run_pipeline(produce(), stages, slow_sink, depth=depth)
    assert state["max_inflight"] <= (len(stages) + 1) * depth + len(stages) + 2


def test_stage_sink_sees_every_stage_execution():
    seen = []
    texec.run_pipeline(
        range(5), [texec.Stage("x", lambda v: v)], lambda _: None, depth=2,
        stage_sink=lambda name, start, elapsed, items: seen.append((name, items)),
    )
    assert sorted(seen).count(("x", 1)) == 5
    assert ("write", 1) in seen and ("read", 1) in seen


def test_perturbed_schedules_give_the_serial_output_bit_for_bit():
    """Three seeded schedules (the port's ``SchedulePerturber``), one
    answer: per-stage delays shift the interleavings and the batch
    gathers, and FIFO order keeps the output the serial loop's."""
    expected = [-(x * x) for x in range(150)]
    for seed in (0, 1, 2):
        perturber = SchedulePerturber(seed, max_delay_s=0.0005)
        out = []
        stats = texec.run_pipeline(
            range(150),
            [texec.Stage("sq", perturber.wrap(lambda x: x * x)),
             texec.Stage("neg", perturber.wrap(lambda xs: [-x for x in xs]), batch_max=4)],
            out.append, depth=3,
        )
        assert out == expected, f"seed {seed} diverged"
        assert stats.stages["sq"]["items"] == 150
