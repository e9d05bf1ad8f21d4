"""Shadow serving: warm the candidate, mirror live traffic, collect deltas.

The JAX package's ``lifecycle/shadow.py``. The ``ShadowEngine`` holds a
FULL candidate ``InferenceEngine`` (its own params, monitor, temperature
and accumulator on the device: the candidate's monitor folds never touch
the live aggregate) and, for the incumbent's side of every comparison, a
second engine over the incumbent bundle as it stood at construction (the
same values as the live engine's exact tier, an accumulator of its own,
so mirrored and holdout rows never fold into the live aggregate; a later
promotion does not change what the candidate is judged against).

Both sides score by the same route: on the card each engine's ``warm``
captures its programs into CUDA graphs of its own, and every mirrored or
holdout batch is one graph replay on each side; on the CPU both run their
programs eagerly. The JAX package shares the live executables with the
candidate instead (params are arguments there; ``warm_mode ==
"shared"``): a CUDA graph bakes in the addresses of its params and of its
engine's accumulator, so the port captures (``warm_mode == "captured"``,
``"eager"`` on the CPU). What the live engine then serves after a
promotion is captured again over its own accumulator by
``InferenceEngine.swap_bundle``.

Mirroring is dispatch-only: the controller drains the engine tee's queue
on ITS thread and calls ``mirror()`` with copies of real request arrays —
both sides score the same rows (timed), responses are discarded, and only
the deltas accumulate: candidate vs incumbent latency on real request
shapes and the per-row prediction shift. The AUC/ECE evidence comes from
``evaluate(holdout)``, scored through both sides' serving programs in
bucket-shaped chunks.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from mlops_tpu_torch.serve.engine import InferenceEngine

_LATENCY_WINDOW = 512  # mirrored-latency samples retained per side


@dataclasses.dataclass
class ShadowReport:
    """Everything the promotion gates consume (lifecycle/promote.py)."""

    auc_candidate: float
    auc_incumbent: float
    auc_delta: float  # candidate - incumbent (negative = regression)
    ece_candidate: float
    ece_incumbent: float
    p99_candidate_ms: float
    p99_incumbent_ms: float
    p50_candidate_ms: float
    p50_incumbent_ms: float
    mirrors: int
    mirror_drops: int
    mean_abs_pred_delta: float
    holdout_rows: int
    warm_mode: str
    warm_s: float


class ShadowEngine:
    def __init__(self, live: InferenceEngine, candidate_bundle: Any):
        if not getattr(live, "monitor_accumulating", False):
            raise ValueError(
                "shadow serving requires a device-accumulating (flax) "
                "live engine"
            )
        self._live = live
        common = dict(
            buckets=tuple(live.buckets),
            device=live.device,
            cuda_graphs=live._use_graphs,
        )
        # The incumbent as it stands now, on its exact tier (the JAX shadow
        # scores the incumbent's exact params whatever tier it serves).
        self._incumbent = InferenceEngine(live.bundle, **common)
        self.engine = InferenceEngine(
            candidate_bundle, tier_routing=live.tier_routing, **common
        )
        self.warm_mode = ""
        self.warm_s = 0.0
        self._stats_lock = threading.Lock()
        self._cand_ms: deque = deque(maxlen=_LATENCY_WINDOW)
        self._inc_ms: deque = deque(maxlen=_LATENCY_WINDOW)
        self._mirrors = 0
        self._drops = 0
        self._pred_delta_sum = 0.0
        self._pred_delta_rows = 0

    # --------------------------------------------------------------- warm
    def warm(self) -> None:
        """Ready both sides' programs: on the card, capture every bucket
        and group geometry of each into its own CUDA graphs."""
        t0 = time.perf_counter()
        self.engine.warmup()
        self._incumbent.warmup()
        self.warm_mode = "captured" if self.engine._use_graphs else "eager"
        self.warm_s = round(time.perf_counter() - t0, 3)

    # ------------------------------------------------------------- mirror
    def mirror(self, cat: np.ndarray, num: np.ndarray) -> None:
        """Score one mirrored request on both sides; keep only deltas.
        Runs on the CONTROLLER thread (the tee queue's consumer), never a
        request thread. All numerics happen outside the stats lock."""
        t0 = time.perf_counter()
        cand = np.asarray(
            self.engine.predict_arrays(cat, num)["predictions"], np.float64
        )
        t1 = time.perf_counter()
        inc = self._score_incumbent(cat, num)
        t2 = time.perf_counter()
        delta = float(np.abs(cand - inc).sum())
        with self._stats_lock:
            self._cand_ms.append((t1 - t0) * 1e3)
            self._inc_ms.append((t2 - t1) * 1e3)
            self._mirrors += 1
            self._pred_delta_sum += delta
            self._pred_delta_rows += len(cand)

    def note_drop(self, count: int = 1) -> None:
        with self._stats_lock:
            self._drops += count

    @property
    def mirrors(self) -> int:
        with self._stats_lock:
            return self._mirrors

    def _score_incumbent(self, cat: np.ndarray, num: np.ndarray) -> np.ndarray:
        """Incumbent predictions for the same rows, through the incumbent
        engine's own programs and accumulator: the same padding and the
        same route as the candidate's, and the live aggregate never
        counts a mirrored row."""
        return np.asarray(
            self._incumbent.predict_arrays(cat, num)["predictions"], np.float64
        )

    # ------------------------------------------------------------ evaluate
    def evaluate(self, holdout, holdout_incumbent=None) -> ShadowReport:
        """Score the labeled holdout through both sides' serving programs
        (bucket-shaped chunks) and fold in the mirrored latency and shift
        evidence. ``holdout_incumbent`` carries the SAME rows encoded with
        the incumbent's preprocessor (it differs only under
        ``lifecycle.refit_preprocessor``): each side is graded in the
        encode configuration it serves."""
        from mlops_tpu_torch.lifecycle.promote import (
            expected_calibration_error,
            roc_auc_np,
        )

        if holdout_incumbent is None:
            holdout_incumbent = holdout
        labels = np.asarray(holdout.labels, np.float64)
        chunk = self.engine.max_bucket
        cand_probs, inc_probs = [], []
        for lo in range(0, holdout.n, chunk):
            cand_probs.append(
                np.asarray(
                    self.engine.predict_arrays(
                        holdout.cat_ids[lo : lo + chunk],
                        holdout.numeric[lo : lo + chunk],
                    )["predictions"],
                    np.float64,
                )
            )
            inc_probs.append(
                self._score_incumbent(
                    holdout_incumbent.cat_ids[lo : lo + chunk],
                    holdout_incumbent.numeric[lo : lo + chunk],
                )
            )
        cand = np.concatenate(cand_probs)
        inc = np.concatenate(inc_probs)
        # Latency evidence comes from MIRRORED traffic only (holdout chunk
        # timings are too few to gate on); with zero mirrors both p99s
        # report 0.0, which evaluate_gates reads as "no evidence".
        with self._stats_lock:
            mirror_cand = list(self._cand_ms)
            mirror_inc = list(self._inc_ms)
            mirrors, drops = self._mirrors, self._drops
            shift_sum = self._pred_delta_sum
            shift_rows = self._pred_delta_rows
        auc_c = roc_auc_np(cand, labels)
        auc_i = roc_auc_np(inc, labels)
        return ShadowReport(
            auc_candidate=auc_c,
            auc_incumbent=auc_i,
            auc_delta=auc_c - auc_i,
            ece_candidate=expected_calibration_error(cand, labels),
            ece_incumbent=expected_calibration_error(inc, labels),
            p99_candidate_ms=_percentile(mirror_cand, 99),
            p99_incumbent_ms=_percentile(mirror_inc, 99),
            p50_candidate_ms=_percentile(mirror_cand, 50),
            p50_incumbent_ms=_percentile(mirror_inc, 50),
            mirrors=mirrors,
            mirror_drops=drops,
            mean_abs_pred_delta=(
                shift_sum / shift_rows if shift_rows else 0.0
            ),
            holdout_rows=int(holdout.n),
            warm_mode=self.warm_mode,
            warm_s=self.warm_s,
        )


def _percentile(samples, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples, np.float64), q))
