"""Hot regrid: ready the plan off the request path, exchange it in with
one reference swap under the engine lock.

The JAX package's ``autotune/apply.py`` for the port's engine. On the TPU
a regrid adds AOT executables to a shared table and swaps in an
architecture twin that adopts it; here a regrid means new CUDA graphs
captured over the engine's one accumulator, and the engine exchanges in a
generation of its own (``InferenceEngine.regrid``), so there is no twin
(``build_grid_twin`` is not ported):

1. **Warm** (`warm_plan`): every ``(tier, bucket)`` the plan needs and the
   serving generation lacks is captured into its graphs and pool
   (``InferenceEngine.warm_grid``), one graph per lock hold on the capture
   stream, for every tier the generation holds, as warmup readies shapes.
   A regrid never captures under a request's dispatch, and a crash
   mid-warm leaves only harmless extra graphs behind.
2. **Exchange** (`apply_plan`): ``InferenceEngine.regrid`` swaps in a
   generation that differs only in its bucket list and shares the graphs
   dict by reference: a request that picked its bucket from the old grid
   just before the exchange replays a graph that exists; `rollback()`
   restores the old grid in one call without a capture.

`AutotuneController` runs the loop periodically off the request path
(the LifecycleController thread discipline): gather ShapeStats demand +
ledger costs, fit, search, gate on ``min_gain_pct``, apply (or dry-run
"planned"), and audit predicted-vs-measured gain from windowed ledger
deltas. On the ring plane the LEAD replica computes and persists the
plan (``plan_dir/plan.json``, atomic); sibling controllers run in
``adopt`` mode and apply the lead's plan locally, each capturing its own
graphs (CUDA graphs do not cross processes; the kernel-library cache
they launch from does).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

from mlops_tpu_torch import faults
from mlops_tpu_torch.autotune.costmodel import (
    demand_from_shapes,
    fit_cost_model,
    ledger_rows_from_snapshot,
)
from mlops_tpu_torch.autotune.search import GridPlan, search_plan
from mlops_tpu_torch.serve.metrics import AUTOTUNE_OUTCOMES
from mlops_tpu_torch.utils.io import atomic_write

logger = logging.getLogger(__name__)

PLAN_FILE = "plan.json"


class RegridAborted(RuntimeError):
    """The live bundle was promoted between warm and exchange: the warmed
    graphs belong to the outgoing generation, and exchanging would
    silently ROLL BACK the promotion. The plan is simply recomputed next
    tick."""


def warm_plan(engine, buckets, stats: dict | None = None) -> int:
    """Capture the plan's missing solo-bucket programs into the LIVE
    engine's serving generation, off the request path. Returns how many
    (tier, bucket) programs were readied (0 = the generation already
    covered the plan); ``stats``, when given, receives the warm's record
    (graphs, capture seconds, pool bytes) for the exchange's."""
    if not engine.monitor_accumulating:
        raise ValueError(
            "autotune requires the device-accumulating (flax) serving "
            "flavor — the sklearn flavor has no AOT exec table to regrid"
        )
    warmed = engine.warm_grid(buckets)
    if stats is not None:
        stats.update(warmed)
    return warmed["graphs"]


def apply_plan(engine, buckets) -> int:
    """Warm + exchange: the full hot regrid. Returns the engine's new
    ``grid_generation``. Raises `RegridAborted` if a lifecycle promotion
    landed during the warm (the exchange would reinstall pre-promotion
    params); the caller retries from fresh telemetry next tick."""
    generation = engine.bundle_generation
    warmed: dict = {}
    warm_plan(engine, buckets, warmed)
    # Fault point: kill -9 here = a crash after the warm captures landed
    # but BEFORE the exchange — the most state a regrid ever has in
    # flight. Nothing durable or shared is mid-mutation (the generation
    # only gained valid graphs; the grid is untouched): a restart serves
    # on the old grid and a re-run regrid completes cleanly.
    faults.fire("autotune.regrid.midswap")
    if engine.bundle_generation != generation:
        raise RegridAborted(
            f"bundle generation moved {generation} -> "
            f"{engine.bundle_generation} during warm; regrid plan is stale"
        )
    return engine.regrid(buckets, warmed)


class AutotuneController:
    """The periodic gridtuner loop — one per engine process, started
    after warmup, stopped at drain (the LifecycleController thread
    pattern: daemon worker, `_stop` event, `run_once` as the testable
    unit, a leaf `_lock` over counters only)."""

    def __init__(
        self,
        engine,
        config,
        adopt: bool = False,
        replica: int = 0,
    ) -> None:
        self.engine = engine
        self.config = config
        self.adopt = bool(adopt)
        self.replica = int(replica)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._plans = {outcome: 0 for outcome in AUTOTUNE_OUTCOMES}
        self._last_plan: GridPlan | None = None
        self._predicted_gain: float | None = None
        self._measured_gain: float | None = None
        self._cooldown_until = 0.0
        # Windowed goodput audit state: last ledger totals over solo
        # entries (useful rows, device seconds) and the rate measured
        # in the window before the last apply.
        self._window_totals: tuple[float, float] | None = None
        self._window_rate: float | None = None
        self._pre_apply_rate: float | None = None
        self._adopted_plan_gen = 0

    # ------------------------------------------------------------ thread
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"autotune-controller-r{self.replica}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.run_once()
            except Exception:
                # The LifecycleController contract: a failed tick (bad
                # telemetry, a failed capture mid-warm, a promotion race)
                # is counted and logged — the controller can never take
                # the serving engine down with it.
                logger.exception("autotune tick failed")
                self._count("failed")

    # ------------------------------------------------------------- ticks
    def _count(self, outcome: str) -> None:
        with self._lock:
            self._plans[outcome] += 1

    def run_once(self, now: float | None = None) -> str:
        """One evaluation. Returns a short status string (tests + the
        offline trace of what the loop decided and why)."""
        if self.adopt:
            return self._run_adopt()
        now = time.monotonic() if now is None else now
        self._measure_window()
        if now < self._cooldown_until:
            return "cooling"
        stats = self.engine.shape_stats
        ledger = self.engine.cost_ledger
        if stats is None or ledger is None:
            return "disarmed"
        shape_entries = stats.snapshot()
        demand = demand_from_shapes(shape_entries)
        dispatches = sum(w for _, w in demand)
        if dispatches < self.config.min_dispatches:
            return f"held: {int(dispatches)} dispatches < min"
        model = fit_cost_model(
            ledger_rows_from_snapshot(ledger.snapshot())
        )
        if model is None:
            return "held: no solo ledger observations"
        plan = search_plan(
            demand, model, tuple(self.engine.buckets),
            self.config.max_entries,
        )
        with self._lock:
            self._last_plan = plan
            self._predicted_gain = plan.predicted_gain_pct
        if (
            plan.buckets == tuple(self.engine.buckets)
            or plan.predicted_gain_pct < self.config.min_gain_pct
        ):
            self._count("rejected")
            return (
                f"rejected: gain {plan.predicted_gain_pct:.1f}% "
                f"(min {self.config.min_gain_pct:g}%)"
            )
        if not self.config.apply:
            self._count("planned")
            self._persist(plan, applied=False)
            return f"planned (dry-run): {list(plan.buckets)}"
        try:
            grid_generation = apply_plan(self.engine, plan.buckets)
        except RegridAborted as exc:
            logger.warning("regrid aborted: %s", exc)
            self._count("failed")
            return "failed: promotion raced the warm phase"
        with self._lock:
            self._pre_apply_rate = self._window_rate
            self._measured_gain = None
        self._cooldown_until = now + self.config.cooldown_s
        self._count("applied")
        self._log_regrid("applied")
        self._persist(plan, applied=True, grid_generation=grid_generation)
        return f"applied: grid_generation={grid_generation}"

    def rollback(self) -> str:
        """Restore the pre-regrid grid in one call (the runbook's manual
        bail-out; the generations share their graphs, so the old grid
        dispatches warm immediately)."""
        self.engine.rollback()
        self._count("rolled_back")
        with self._lock:
            self._pre_apply_rate = None
            self._measured_gain = None
        return f"rolled_back: grid_generation={self.engine.grid_generation}"

    def _measure_window(self) -> None:
        """Windowed measured goodput from ledger deltas: useful rows per
        device-second over THIS tick's window — directly comparable to
        the plan's predicted ``useful_rows_per_s`` and load-shape
        independent (both numerator and denominator come from the same
        dispatched window)."""
        ledger = self.engine.cost_ledger
        if ledger is None:
            return
        rows = device_s = 0.0
        for row in ledger_rows_from_snapshot(ledger.snapshot()):
            if not str(row["entry"]).startswith("bucket_"):
                continue
            rows += row["rows"]
            device_s += row["device_s"]
        prev = self._window_totals
        self._window_totals = (rows, device_s)
        if prev is None:
            return
        d_rows, d_dev = rows - prev[0], device_s - prev[1]
        if d_dev <= 0 or d_rows <= 0:
            return
        rate = d_rows / d_dev
        with self._lock:
            self._window_rate = rate
            if self._pre_apply_rate and self._pre_apply_rate > 0:
                self._measured_gain = (
                    100.0 * (rate - self._pre_apply_rate)
                    / self._pre_apply_rate
                )

    # ---------------------------------------------------- plan file (ring)
    def _plan_path(self) -> Path:
        return Path(self.config.plan_dir) / PLAN_FILE

    def _persist(
        self, plan: GridPlan, applied: bool, grid_generation: int = 0
    ) -> None:
        if not self.config.plan_dir:
            return
        doc = plan.as_dict()
        doc["applied"] = bool(applied)
        doc["grid_generation"] = int(grid_generation)
        doc["replica"] = self.replica
        try:
            path = self._plan_path()
            path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write(path, (json.dumps(doc) + "\n").encode())
        except OSError:
            # The plan file is adoption/audit metadata, never
            # load-bearing for the plane that already applied the grid.
            logger.exception("failed to persist autotune plan")

    def _run_adopt(self) -> str:
        """Sibling-replica mode (ring plane): apply the lead's persisted
        plan locally, capturing this process's own graphs (the kernel
        libraries they launch come from the shared cache)."""
        path = self._plan_path()
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return "adopt: no plan"
        plan_gen = int(doc.get("grid_generation", 0))
        if not doc.get("applied") or plan_gen <= self._adopted_plan_gen:
            return "adopt: current"
        buckets = tuple(int(b) for b in doc.get("buckets", ()))
        if not buckets:
            return "adopt: malformed plan"
        if buckets == tuple(self.engine.buckets):
            self._adopted_plan_gen = plan_gen
            return "adopt: already on plan grid"
        try:
            grid_generation = apply_plan(self.engine, buckets)
        except RegridAborted:
            self._count("failed")
            return "failed: promotion raced the adopt warm"
        self._adopted_plan_gen = plan_gen
        self._count("applied")
        self._log_regrid("adopted")
        return f"adopted: grid_generation={grid_generation}"

    def _log_regrid(self, how: str) -> None:
        """One log line per regrid with the engine's record of it (graphs
        captured, capture seconds, pool bytes, the exchange's critical
        section): the plane's log carries each replica's."""
        logger.info("autotune regrid %s: %s", how, json.dumps(
            {"replica": self.replica, **getattr(self.engine, "swap_stats", {})}))

    # ------------------------------------------------------------ reads
    def metrics_snapshot(self) -> dict[str, Any]:
        """The shared-formatter input (`ServingMetrics.autotune_lines`)
        — also what the ring telemetry loop mirrors into shm."""
        with self._lock:
            return {
                "grid_generation": int(self.engine.grid_generation),
                "plans": dict(self._plans),
                "predicted_gain_pct": self._predicted_gain,
                "measured_gain_pct": self._measured_gain,
            }

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "adopt": self.adopt,
                "replica": self.replica,
                "grid": list(self.engine.buckets),
                "grid_generation": int(self.engine.grid_generation),
                "plans": dict(self._plans),
                "predicted_gain_pct": self._predicted_gain,
                "measured_gain_pct": self._measured_gain,
                "last_plan": (
                    self._last_plan.as_dict() if self._last_plan else None
                ),
            }
