"""The port's TensorBoard sink (``mlops_tpu_torch/utils/tboard.py`` and
``train/loop.py metric_writers``) against the JAX package's, on the CPU.

The same metric records go through both packages' writers; the event
files they write hold the same scalars (read back with TensorBoard's
event reader where it imports). When ``torch.utils.tensorboard`` cannot
be imported (made so with ``monkeypatch``), both warn with the same text,
write no event file, and ``metrics.jsonl`` is still written."""

import json
import sys
import warnings

import pytest

from mlops_tpu.config import TrainConfig as JaxTrainConfig
from mlops_tpu.train.loop import metric_writers as jax_metric_writers
from mlops_tpu_torch.train.loop import metric_writers

RECORDS = [
    {"step": 10, "train_loss": 0.61, "validation_roc_auc_score": 0.71, "note": "text"},
    {"step": 20, "train_loss": 0.52, "validation_roc_auc_score": 0.74},
]


def _write(who, tmp_path, records=RECORDS):
    run = tmp_path / who
    tb_dir = run / "tb"
    if who == "jax":
        sink = jax_metric_writers(run / "metrics.jsonl", JaxTrainConfig(tensorboard_dir=str(tb_dir)))
    else:
        sink = metric_writers(run / "metrics.jsonl", str(tb_dir))
    with sink as emit:
        for record in records:
            emit(record)
    return run


def _scalars(tb_dir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {tag: [(e.step, round(e.value, 6)) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_event_files_hold_the_records_the_jax_writer_writes(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    runs = {who: _write(who, tmp_path) for who in ("jax", "port")}
    for run in runs.values():
        assert list((run / "tb").glob("events.out.tfevents.*"))
    rows = [json.loads(line) for line in (runs["port"] / "metrics.jsonl").open()]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in rows] == RECORDS
    try:
        got, want = (_scalars(runs[who] / "tb") for who in ("port", "jax"))
    except ImportError:
        return  # no event reader here: the files' presence is what is held
    assert got == want == {
        "train_loss": [(10, 0.61), (20, 0.52)],
        "validation_roc_auc_score": [(10, 0.71), (20, 0.74)],
    }


def test_without_tensorboard_both_warn_and_metrics_jsonl_is_written(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    messages = {}
    for who in ("jax", "port"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = _write(who, tmp_path)
        messages[who] = [str(w.message) for w in caught]
        assert not list((run / "tb").glob("events.out.tfevents.*"))
        assert len((run / "metrics.jsonl").read_text().splitlines()) == len(RECORDS)
    assert messages["port"] == messages["jax"]
    (message,) = messages["port"]
    assert message.startswith("tensorboard writer unavailable (")
    assert message.endswith("); metrics go to metrics.jsonl only")
