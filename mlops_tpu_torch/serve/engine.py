"""Inference engine: bundle -> warmed, bucketed, fused predict, on the
exact or the quant tier.

Port of the JAX package's ``serve/engine.py`` for its two single-device
tiers:

- the tier table ``exact | quant | auto`` (``_resolve_tier``): exact is
  the default, quant is a demand (raise rather than serve other bits than
  asked for), auto takes a gated quant tier and otherwise falls back to
  exact, logging why;
- requests pad up to the nearest row bucket (1, 8, 64, 256 by default)
  with a validity mask, so drift and outlier statistics ignore padding;
- one packed program per dispatch, grouped requests included: on the
  exact tier the model, flags, drift and fold in plain PyTorch
  (``ops/predict.py``), on the quant tier one CUDA kernel launch plus the
  p-value tail (``ops/quant_kernel.py``);
- the device -> host surface is ONE packed f32 buffer per dispatch
  (predictions ‖ outlier flags ‖ drift). Dispatch enqueues the work on
  the current stream and starts a non-blocking copy into pinned host
  memory behind a CUDA event; fetch waits on that event;
- the running monitor aggregate stays on the device and is read off the
  request path by ``monitor_snapshot`` (fetch-and-reset into f64 host
  totals; a window whose fetch fails folds back into the live one).
"""

from __future__ import annotations

import bisect
import copy
import logging
import threading
import time
from typing import Any

import numpy as np
import torch

from mlops_tpu_torch.bundle.bundle import Bundle
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.monitor.state import init_accumulator, merge_accumulators
from mlops_tpu_torch.ops.predict import (
    make_packed_grouped_base,
    make_packed_predict_base,
    model_params,
    packed_layout,
)
from mlops_tpu_torch.ops.quant_kernel import (
    make_quant_grouped_base,
    make_quant_packed_base,
)
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve.wire import (
    EMPTY_RESPONSE_BYTES,
    GROUP_ROW_BUCKET,
    GROUP_ROW_BUCKETS,
    GROUP_SLOT_BUCKETS,
    empty_response,
    encode_response,
    format_response,
)

logger = logging.getLogger(__name__)
TIERS = ("exact", "quant", "auto")


def _pad_rows(
    cat: np.ndarray, num: np.ndarray, n: int, rows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``n`` encoded rows up to ``rows`` with a validity mask."""
    pad = rows - n
    if pad:
        cat = np.pad(cat, ((0, pad), (0, 0)))
        num = np.pad(num, ((0, pad), (0, 0)))
    return cat, num, np.arange(rows) < n


class _Handle:
    """An in-flight dispatch: the packed output's host buffer, the event
    its copy completes behind (None on the CPU), and the geometry the
    fetch side needs to slice it."""

    __slots__ = ("host", "event", "n", "rows", "sizes", "slots")

    def __init__(self, host, event, n=0, rows=0, sizes=None, slots=0):
        self.host = host
        self.event = event
        self.n = n
        self.rows = rows
        self.sizes = sizes
        self.slots = slots

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class InferenceEngine:
    def __init__(
        self,
        bundle: Bundle,
        buckets: tuple[int, ...] = (1, 8, 64, 256),
        serve_tier: str = "exact",
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.serve_tier = self._resolve_tier(serve_tier, bundle)
        self.bundle = bundle
        self.buckets = sorted(buckets)
        self.max_bucket = self.buckets[-1]
        # Committed once: the tier's params, the monitor and the
        # temperature are arguments of every dispatch and stay on the
        # device.
        if self.serve_tier == "quant":
            self._params = {
                k: v.to(self.device) for k, v in bundle.quant_params.items()
            }
            temperature = bundle.quant_temperature
            self._predict = make_quant_packed_base()
            self._predict_group = make_quant_grouped_base()
        else:
            # The programs apply these params to the module (which has no
            # buffers) by swapping them in for the call, under the
            # accumulator lock; the engine's own copy keeps another engine
            # over the same bundle out of the swap.
            model = copy.deepcopy(bundle.model).eval()
            self._params = {
                k: v.to(self.device) for k, v in model_params(model).items()
            }
            temperature = bundle.temperature
            self._predict = make_packed_predict_base(model)
            self._predict_group = make_packed_grouped_base(model)
        self._monitor = bundle.monitor.to(self.device)
        self._temperature = torch.tensor(
            temperature, dtype=torch.float32, device=self.device
        )
        # The lock orders the accumulator chain: each dispatch reads the
        # current accumulator and installs the one its program returns.
        # On the card the hold is an enqueue, never a wait.
        self._acc = init_accumulator(self.device)
        self._acc_lock = threading.Lock()
        d = SCHEMA.num_categorical + SCHEMA.num_numeric
        self._totals: dict[str, Any] = {
            "rows": 0.0,
            "outliers": 0.0,
            "batches": 0.0,
            "drift_sum": np.zeros(d, np.float64),
            "drift_last": np.zeros(d, np.float64),
        }
        self._totals_lock = threading.Lock()
        self.warmup_stats: dict[str, Any] = {}
        self.ready = False

    def _resolve_tier(self, serve_tier: str, bundle: Bundle) -> str:
        """The JAX package's tier table: "exact" serves the bundle's exact
        model; "quant" demands a GATED quant tier and raises otherwise (an
        ungraded tier must never serve); "auto" takes the quant tier when
        it is admissible and falls back to exact, logging why. What this
        package cannot serve on either tier is refused with its reason."""
        if serve_tier not in TIERS:
            raise ValueError(
                f"serve_tier must be 'exact', 'quant' or 'auto', got {serve_tier!r}"
            )
        if serve_tier != "exact":
            why = ""
            if bundle.flavor == "sklearn":
                why = "sklearn bundles have no quant tier"
            elif not bundle.has_quant:
                why = "bundle carries no quant params"
            elif not bundle.quant_gates_passed:
                why = (
                    "quant tier failed (or was never graded by) the promotion "
                    "gates"
                )
            if not why:
                return "quant"
            if serve_tier == "quant":
                raise ValueError(f"serve_tier='quant' refused: {why}")
            logger.info("serve_tier='auto' falling back to exact tier: %s", why)
        why = ""
        if bundle.flavor == "sklearn":
            why = (
                "sklearn bundles score on the host tree ensemble, which is "
                "not ported (ROADMAP A8)"
            )
        elif bundle.flavor != "flax":
            why = f"a {bundle.flavor!r} bundle is scored by predict-file, not served"
        elif bundle.model is None:
            why = bundle.exact_refusal or "bundle carries no exact model"
        if why:
            raise ValueError(f"serve_tier={serve_tier!r} refused: {why}")
        return "exact"

    # ------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Run every bucket and every group geometry once on zeros (first
        launch, kernel library load, allocator warm-up) against a scratch
        accumulator, so the live monitor aggregate sees nothing."""
        t0 = time.perf_counter()
        c, m = SCHEMA.num_categorical, SCHEMA.num_numeric
        scratch = init_accumulator(self.device)
        programs = 0
        for rows in self.buckets:
            _, scratch = self._run(
                self._predict, scratch,
                *self._to_device(
                    np.zeros((rows, c), np.int32),
                    np.zeros((rows, m), np.float32),
                    np.ones((rows,), bool),
                ),
            )
            programs += 1
        for rows in GROUP_ROW_BUCKETS:
            for slots in GROUP_SLOT_BUCKETS:
                _, scratch = self._run(
                    self._predict_group, scratch,
                    *self._to_device(
                        np.zeros((slots, rows, c), np.int32),
                        np.zeros((slots, rows, m), np.float32),
                        np.ones((slots, rows), bool),
                    ),
                )
                programs += 1
        scratch.rows.cpu()  # waits for every warmup launch to finish
        self.warmup_stats = {
            "warmup_s": round(time.perf_counter() - t0, 3),
            "programs": programs,
            "device": str(self.device),
            "tier": self.serve_tier,
        }
        self.ready = True

    # ----------------------------------------------------------- dispatch
    def _to_device(self, cat, num, mask) -> tuple[torch.Tensor, ...]:
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (cat, num, mask)
        )

    def _run(self, program, acc, *batch):
        """One packed program on the tier's committed state (no autograd)."""
        with torch.inference_mode():
            return program(
                self._params, self._monitor, acc, self._temperature, *batch
            )

    def _dispatch(self, program, cat, num, mask) -> tuple[torch.Tensor, Any]:
        """Run one packed program, thread the accumulator through it and
        start the packed buffer's copy to the host."""
        batch = self._to_device(cat, num, mask)
        with self._acc_lock:
            out, self._acc = self._run(program, self._acc, *batch)
        if self.device.type == "cpu":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _bucket_for(self, n: int) -> int | None:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[i] if i < len(self.buckets) else None

    def dispatch_arrays(
        self, cat_ids: np.ndarray, numeric: np.ndarray
    ) -> _Handle | None:
        """Pad to the bucket and enqueue the fused dispatch without
        waiting for it; None for the empty request (no device work)."""
        n = cat_ids.shape[0]
        if n == 0:
            return None
        bucket = self._bucket_for(n)
        rows = bucket if bucket is not None else n
        cat, num, mask = _pad_rows(cat_ids, numeric, n, rows)
        host, event = self._dispatch(self._predict, cat, num, mask)
        return _Handle(host, event, n=n, rows=rows)

    def fetch_arrays_raw(
        self, handle: _Handle
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for the packed buffer: ``(predictions f64[n], outliers
        f64[n], drift f64[D] rounded to 6 places)``."""
        arr = handle.wait()
        p, o, d = packed_layout(handle.rows)
        return (
            arr[p][: handle.n].astype(float),
            arr[o][: handle.n].astype(float),
            arr[d].astype(float).round(6),
        )

    def fetch_arrays(self, handle: _Handle) -> dict[str, Any]:
        return format_response(*self.fetch_arrays_raw(handle))

    def fetch_arrays_wire(self, handle: _Handle) -> bytes:
        return encode_response(*self.fetch_arrays_raw(handle))

    def predict_arrays(
        self, cat_ids: np.ndarray, numeric: np.ndarray
    ) -> dict[str, Any]:
        handle = self.dispatch_arrays(cat_ids, numeric)
        if handle is None:
            return empty_response()
        return self.fetch_arrays(handle)

    def predict_records(self, records: list[dict[str, Any]]) -> dict[str, Any]:
        """Validated records -> the reference response dict."""
        ds = self.bundle.preprocessor.encode(records_to_columns(records))
        return self.predict_arrays(ds.cat_ids, ds.numeric)

    def predict_records_wire(self, records: list[dict[str, Any]]) -> bytes:
        """Validated records -> response wire bytes."""
        ds = self.bundle.preprocessor.encode(records_to_columns(records))
        handle = self.dispatch_arrays(ds.cat_ids, ds.numeric)
        if handle is None:
            return EMPTY_RESPONSE_BYTES
        return self.fetch_arrays_wire(handle)

    # ----------------------------------------------------- grouped predict
    def dispatch_group_arrays(
        self, parts: list[tuple[np.ndarray, np.ndarray]]
    ) -> _Handle:
        """One dispatch for 2..64 pre-encoded requests of 1..8 rows each:
        slots pad to a slot bucket, rows to 1 (all batch-1) or 8, and
        every slot's drift is computed over its own rows."""
        sizes = [cat.shape[0] for cat, _ in parts]
        if not 2 <= len(parts) <= GROUP_SLOT_BUCKETS[-1]:
            raise ValueError(
                f"grouped dispatch takes 2..{GROUP_SLOT_BUCKETS[-1]} "
                f"requests, got {len(parts)}"
            )
        if not all(1 <= n <= GROUP_ROW_BUCKET for n in sizes):
            raise ValueError(
                f"grouped requests must have 1..{GROUP_ROW_BUCKET} records, "
                f"got sizes {sizes}"
            )
        slots = GROUP_SLOT_BUCKETS[
            bisect.bisect_left(GROUP_SLOT_BUCKETS, len(parts))
        ]
        rows = GROUP_ROW_BUCKETS[0] if max(sizes) == 1 else GROUP_ROW_BUCKET
        cat = np.zeros((slots, rows, SCHEMA.num_categorical), np.int32)
        num = np.zeros((slots, rows, SCHEMA.num_numeric), np.float32)
        mask = np.zeros((slots, rows), bool)
        for i, (part_cat, part_num) in enumerate(parts):
            n = sizes[i]
            cat[i, :n] = part_cat
            num[i, :n] = part_num
            mask[i, :n] = True
        host, event = self._dispatch(self._predict_group, cat, num, mask)
        return _Handle(host, event, rows=rows, sizes=sizes, slots=slots)

    def fetch_group_raw(
        self, handle: _Handle
    ) -> tuple[list[int], np.ndarray, np.ndarray, np.ndarray]:
        """``(sizes, predictions f64[slots, rows], outliers f64[slots,
        rows], drift f64[slots, D] rounded)``."""
        arr = handle.wait()
        p, o, d = packed_layout(handle.rows)
        return (
            handle.sizes,
            arr[:, p].astype(float),
            arr[:, o].astype(float),
            arr[:, d].astype(float).round(6),
        )

    def fetch_group(self, handle: _Handle) -> list[dict[str, Any]]:
        sizes, preds, outs, drifts = self.fetch_group_raw(handle)
        return [
            format_response(preds[i, :n], outs[i, :n], drifts[i])
            for i, n in enumerate(sizes)
        ]

    # ------------------------------------------------------------ monitor
    def monitor_snapshot(self) -> dict[str, Any]:
        """ONE device -> host read of the monitor aggregate, off the
        request path. Fetch-and-reset: a zero accumulator is swapped in
        under the lock and the fetched window folds into exact f64 host
        totals, so the f32 device counters never approach 2^24. A window
        whose fetch fails folds back into the live accumulator: the counts
        are delayed, never dropped."""
        with self._acc_lock:
            window = self._acc
            self._acc = init_accumulator(self.device)
        try:
            host = {
                k: getattr(window, k).double().cpu().numpy()
                for k in ("rows", "outliers", "batches", "drift_sum", "drift_last")
            }
        except Exception:
            with self._acc_lock:
                self._acc = merge_accumulators(window, self._acc)
            raise
        window_batches = float(host["batches"])
        with self._totals_lock:
            t = self._totals
            t["rows"] += float(host["rows"])
            t["outliers"] += float(host["outliers"])
            t["batches"] += window_batches
            t["drift_sum"] = t["drift_sum"] + host["drift_sum"]
            if window_batches:
                t["drift_last"] = host["drift_last"]
            rows, outliers, batches = t["rows"], t["outliers"], t["batches"]
            drift_sum, drift_last = t["drift_sum"], t["drift_last"]
        drift_mean = drift_sum / max(batches, 1.0)
        return {
            "rows": rows,
            "outliers": outliers,
            "batches": batches,
            "drift_last": dict(
                zip(SCHEMA.feature_names, drift_last.round(6).tolist())
            ),
            "drift_mean": dict(
                zip(SCHEMA.feature_names, drift_mean.round(6).tolist())
            ),
            "drift_sum": drift_sum.tolist(),
        }
