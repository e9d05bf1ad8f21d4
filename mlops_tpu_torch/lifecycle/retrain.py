"""Off-hot-path incremental retrain: labeled window -> candidate bundle.

The JAX package's ``lifecycle/retrain.py``. Two pieces:

- ``SampleReservoir`` — a bounded on-disk reservoir of encoded serving
  rows (algorithm R on numpy: every scored row has equal probability of
  residing in the fixed-size buffer regardless of traffic volume; the
  same seed and batches give the same rows as the JAX package's), fed
  from the serve path through the engine's lifecycle tee and persisted
  atomically (tmp+rename npz, readable by both packages) so a restart
  keeps its window.
- ``run_retrain`` — the retrain itself, run on the controller thread,
  never a request thread: read the labeled window
  (``lifecycle.labeled_path``: serving traffic is unlabeled; realized
  outcomes arrive out of band through this file), optionally re-fit the
  preprocessor over it (``data/stream.py fit_streaming``), fine-tune from
  the INCUMBENT's params with a small step budget (``train/loop.fit`` with
  checkpoints: a preempted retrain resumes), re-fit the monitor's drift
  reference and outlier detector on the recent window at the incumbent's
  K-S width, re-fit calibration on the held-out split, and package a
  candidate bundle under ``<lifecycle.dir>/candidates/``. On the card the
  retrain runs on a stream of its own, beside the serving engine's, and
  waits on nothing device-wide.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mlops_tpu_torch import faults
from mlops_tpu_torch.config import Config, TrainConfig
from mlops_tpu_torch.schema.features import SCHEMA


class LifecycleError(RuntimeError):
    """A lifecycle step that cannot proceed (no labeled window, window too
    small, flavor mismatch) — named so the controller can log-and-cool
    instead of crashing the serve process."""

# tpulint Layer-3 manifest (analysis/concurrency.py, read from source):
# the reservoir's one leaf lock guards its rows and counters.
TPULINT_LOCK_ORDER = {"SampleReservoir": ("_lock",)}


class SampleReservoir:
    """Bounded uniform sample of encoded serving rows (algorithm R).

    Thread-safe: ``add_batch`` is called from the controller's drain of
    the tee queue (one thread in production), but the lock keeps direct
    feeding from tests safe too. The RNG is seeded, so a single-threaded
    feed is deterministic.
    """

    def __init__(self, capacity: int, directory: str | Path, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"reservoir capacity {capacity} must be >= 1")
        self.capacity = capacity
        self.directory = Path(directory)
        self._cat = np.zeros((capacity, SCHEMA.num_categorical), np.int32)
        self._num = np.zeros((capacity, SCHEMA.num_numeric), np.float32)
        self._filled = 0
        self._seen = 0
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        return self.directory / "reservoir.npz"

    def add_batch(self, cat: np.ndarray, num: np.ndarray) -> None:
        """Fold one request's rows into the reservoir, row by row."""
        n = int(cat.shape[0])
        if n == 0:
            return
        cat = np.asarray(cat, np.int32)
        num = np.asarray(num, np.float32)
        with self._lock:
            for i in range(n):
                self._seen += 1
                if self._filled < self.capacity:
                    slot = self._filled
                    self._filled += 1
                else:
                    draw = int(self._rng.integers(0, self._seen))
                    if draw >= self.capacity:
                        continue
                    slot = draw
                self._cat[slot] = cat[i]
                self._num[slot] = num[i]

    def window(self) -> tuple[np.ndarray, np.ndarray]:
        """(cat int32[k, C], num f32[k, N]) copies of the filled rows."""
        with self._lock:
            k = self._filled
            return self._cat[:k].copy(), self._num[:k].copy()

    @property
    def rows(self) -> int:
        with self._lock:
            return self._filled

    @property
    def rows_seen(self) -> int:
        with self._lock:
            return self._seen

    def save(self) -> Path:
        """Atomic snapshot (tmp+rename): the copy happens under the lock,
        the file I/O outside it."""
        with self._lock:
            payload = {
                "cat": self._cat[: self._filled].copy(),
                "num": self._num[: self._filled].copy(),
                "seen": np.int64(self._seen),
            }
        self.directory.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(self.directory), suffix=".reservoir.tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            # Fault point: a kill between the tmp write and the rename
            # must leave no snapshot or the previous intact one.
            faults.fire("lifecycle.reservoir.midwrite")
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return self.path

    def load(self) -> bool:
        """Restore a prior snapshot if one exists; True when restored."""
        if not self.path.is_file():
            return False
        with np.load(self.path) as data:
            cat, num = data["cat"], data["num"]
            seen = int(data["seen"])
        k = min(len(cat), self.capacity)
        with self._lock:
            self._cat[:k] = cat[:k]
            self._num[:k] = num[:k]
            self._filled = k
            self._seen = max(seen, k)
        return True


def _match_monitor_ref(monitor, train_ds, target: int, seed: int):
    """Resize the candidate monitor's K-S reference sample to the
    INCUMBENT's width. ``fit_monitor`` samples min(drift_ref_size, n)
    rows, so a labeled window smaller than the incumbent's training set
    would shrink ``num_ref_sorted``/``num_ref_cdf`` — and with it the
    shape every captured program of the candidate reads. A window smaller
    than the target resamples WITH replacement (the tie-aware
    right-continuous CDF handles the duplicates)."""
    from mlops_tpu_torch.monitor.state import MonitorState, _ref_cdf

    current = int(monitor.num_ref_sorted.shape[1])
    if current == target:
        return monitor
    rng = np.random.default_rng(seed)
    numeric = np.asarray(train_ds.numeric, np.float32)
    n = numeric.shape[0]
    idx = rng.choice(n, size=target, replace=n < target)
    ref = np.sort(numeric[idx], axis=0).T  # [M, target]
    arrays = monitor.to_arrays()
    arrays["num_ref_sorted"] = ref
    arrays["num_ref_cdf"] = _ref_cdf(ref)
    return MonitorState.from_arrays(arrays)


@dataclasses.dataclass
class RetrainResult:
    candidate_dir: Path
    bundle: Any  # the loaded candidate Bundle
    holdout: Any  # EncodedDataset — the held-out split, CANDIDATE encode
    holdout_incumbent: Any  # the SAME held-out rows encoded with the
    # incumbent's preprocessor (identical object when no refit): the
    # gates must score each side in the encode configuration IT serves
    metrics: dict[str, float]  # candidate validation metrics (fit)
    labeled_rows: int
    wall_s: float
    refit_preprocessor: bool
    fit_s: float = 0.0  # seconds of the fine-tune (``fit``) alone


def run_retrain(
    incumbent,
    config: Config,
    generation: int,
    seed: int = 0,
    attempt: int = 1,
    reservoir_window: tuple[np.ndarray, np.ndarray] | None = None,
    device: str | torch.device | None = None,
) -> RetrainResult:
    """Labeled window -> fine-tuned candidate bundle + checkpointed run.

    ``incumbent`` is the live Bundle (flax flavor required). Raises
    ``LifecycleError`` on a missing or undersized labeled window so the
    controller can cool down instead of crashing the serve process.

    ``attempt`` scopes the checkpoint and candidate directories per
    trigger (``gen-<generation>-t<attempt>``): a COMPLETED checkpoint under
    the tag is wiped (resuming it would return the stale params
    untouched), a partial one resumes. ``reservoir_window`` — (cat
    int32[k, C], num f32[k, N]) from the serve-path reservoir — refits
    the candidate's drift reference and outlier detector on recent
    serving traffic when it carries at least min(train rows, 512) rows.
    ``device`` is where the fine-tune runs (``config.train.device`` when
    None; the serving loop passes its engine's).
    """
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.data.encode import EncodedDataset
    from mlops_tpu_torch.data.ingest import load_table_columns
    from mlops_tpu_torch.data.stream import fit_streaming
    from mlops_tpu_torch.device import own_stream, resolve_device
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.train.calibrate import calibration_record
    from mlops_tpu_torch.train.loop import eval_logits, fit
    from mlops_tpu_torch.train.pipeline import split_dataset
    from mlops_tpu_torch.weights import load_params

    lc = config.lifecycle.validate()
    if incumbent.flavor != "flax" or incumbent.model is None:
        raise LifecycleError(
            f"retrain requires a flax-flavor incumbent, got "
            f"{incumbent.flavor!r} (tree/doc bundles redeploy instead)"
        )
    if not lc.labeled_path:
        raise LifecycleError(
            "lifecycle.labeled_path is empty — no labeled window to "
            "retrain on (serving traffic is unlabeled; deliver realized "
            "outcomes to a CSV/Parquet with the target column)"
        )
    t0 = time.perf_counter()
    columns, labels = load_table_columns(lc.labeled_path)
    if labels is None:
        raise LifecycleError(
            f"{lc.labeled_path} has no target column — the retrain window "
            "must be labeled"
        )
    n_rows = len(labels)
    if n_rows < lc.min_labeled_rows:
        raise LifecycleError(
            f"labeled window has {n_rows} rows < "
            f"lifecycle.min_labeled_rows={lc.min_labeled_rows}"
        )
    if lc.refit_preprocessor:
        preprocessor = fit_streaming(lc.labeled_path)
    else:
        preprocessor = incumbent.preprocessor
    ds = preprocessor.encode(columns, labels)
    train_ds, valid_ds = split_dataset(ds, 0.2)
    if lc.refit_preprocessor:
        # Same rows, INCUMBENT encode, for the gate comparison: the split
        # permutation depends only on (n, seed).
        _, valid_inc = split_dataset(
            incumbent.preprocessor.encode(columns, labels), 0.2
        )
    else:
        valid_inc = valid_ds

    dev = resolve_device(device if device is not None else config.train.device)
    steps = lc.retrain_steps
    tcfg = TrainConfig(
        batch_size=min(lc.retrain_batch_size, max(1, train_ds.n)),
        steps=steps,
        eval_every=steps,
        warmup_steps=max(1, steps // 10),
        seed=seed,
        checkpoint_every=max(1, steps // 2),
        keep_best=True,
        device=str(dev),
    )
    state_dir = Path(lc.dir)
    tag = f"gen-{generation}-t{attempt}"
    ckpt_dir = state_dir / "checkpoints" / tag
    # A COMPLETED prior run under this tag must never be resumed (attempt
    # tags collide across process restarts and offline reruns); a PARTIAL
    # checkpoint (crash mid-retrain) is exactly what resume is for.
    latest = ckpt_dir / "latest.json"
    if latest.is_file():
        try:
            done_step = int(json.loads(latest.read_text()).get("step", 0))
        except (OSError, ValueError):
            done_step = 0
        if done_step >= lc.retrain_steps:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    model_config = incumbent.model_config
    # On the card: a stream no engine holds, so no launch lands on (or
    # waits behind) the serving engine's streams.
    stream = own_stream(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with stream:
        t_fit = time.perf_counter()
        result = fit(
            build_model(model_config),
            train_ds,
            valid_ds,
            tcfg,
            init_state=incumbent.model.state_dict(),
            metrics_path=ckpt_dir / "metrics.jsonl",
            checkpoint_dir=ckpt_dir,
            device=dev,
        )
        fit_s = time.perf_counter() - t_fit
        packaged = load_params(build_model(model_config), result.params).to(dev)
        logits = eval_logits(
            packaged,
            dict(packaged.named_parameters()),
            torch.from_numpy(valid_ds.cat_ids).to(dev),
            torch.from_numpy(valid_ds.numeric).to(dev),
        ).cpu().numpy()
    calibration = calibration_record(logits, valid_ds.labels)
    monitor_ds = train_ds
    if reservoir_window is not None and (
        len(reservoir_window[0]) >= min(train_ds.n, 512)
    ):
        monitor_ds = EncodedDataset(
            cat_ids=reservoir_window[0],
            numeric=reservoir_window[1],
            labels=None,
        )
    monitor = _match_monitor_ref(
        fit_monitor(monitor_ds, seed=seed), monitor_ds,
        target=int(incumbent.monitor.num_ref_sorted.shape[1]), seed=seed,
    )
    candidate_dir = state_dir / "candidates" / tag
    save_exact_bundle(
        candidate_dir,
        model_config,
        packaged.cpu(),
        preprocessor,
        monitor,
        metrics=result.metrics,
        tags={
            "lifecycle": "candidate",
            "parent_generation": str(generation - 1),
            "labeled_rows": str(n_rows),
        },
        calibration=calibration,
    )
    return RetrainResult(
        candidate_dir=candidate_dir,
        bundle=load_bundle(candidate_dir),
        holdout=valid_ds,
        holdout_incumbent=valid_inc,
        metrics=result.metrics,
        labeled_rows=n_rows,
        wall_s=round(time.perf_counter() - t0, 3),
        refit_preprocessor=lc.refit_preprocessor,
        fit_s=round(fit_s, 3),
    )
