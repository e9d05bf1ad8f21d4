"""The lifecycle controller: the component that ACTS on what the monitor
sees — drift trigger -> off-hot-path retrain -> shadow mirror -> gated
hot promotion, with instant rollback and cooldown.

The JAX package's ``lifecycle/controller.py``, unchanged in behaviour but
for one thing: the retrain runs on the serving engine's device (on the
card, on a stream of its own beside the engine's). Its fault points
(``lifecycle.retrain``, ``lifecycle.shadow.evaluate``) feed the circuit
breaker as the JAX ones do.

Threading model: the controller owns ONE worker thread
(`start`/`stop`) running ``run_once`` every ``lifecycle.tick_s``. All
heavy work — draining the tee queue into the reservoir, mirrored shadow
scoring, the retrain itself, monitor-aggregate fetches, gate evaluation,
the swap — happens on that thread (or the caller's, when tests drive
``run_once`` directly), NEVER on a request thread. The request path's
entire contribution is the engine tee: one bounded ``queue.Queue``
put_nowait per request (copies the arrays — the multi-worker ring's
slabs are reused after release, so views must not escape) which drops
and counts when full. ``_lock`` is a leaf guarding the small mutable
status/counter state; nothing blocking ever runs under it.

State machine (one transition per ``run_once``):

    idle --trigger fired--> retraining (inline, checkpointed)
         --candidate built--> shadowing (mirror live traffic)
         --evidence in--> gate evaluation --> promoted | rejected
         --either way--> cooldown --> idle

A promotion that later regresses rolls back in one ``rollback()`` call
(the engine retains the previous bundle's device state and exec table).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any

from mlops_tpu_torch import faults
from mlops_tpu_torch.config import Config
from mlops_tpu_torch.lifecycle.promote import (
    evaluate_gates,
    promote_engine,
    rollback_engine,
)
from mlops_tpu_torch.lifecycle.retrain import (
    LifecycleError,
    SampleReservoir,
    run_retrain,
)
from mlops_tpu_torch.lifecycle.shadow import ShadowEngine
from mlops_tpu_torch.lifecycle.triggers import TriggerPolicy

logger = logging.getLogger("mlops_tpu_torch.lifecycle")

_TEE_QUEUE_SLOTS = 256  # bounded hot-path -> controller handoff

# tpulint Layer-3 manifest (analysis/concurrency.py, read from source):
# the controller's one leaf lock guards its state machine's snapshot.
TPULINT_LOCK_ORDER = {"LifecycleController": ("_lock",)}


class LifecycleController:
    def __init__(
        self,
        engine: Any,
        config: Config,
        clock=time.monotonic,
        force_incumbent_preprocessor: bool = False,
    ):
        self.engine = engine
        self.config = config
        self.lifecycle = config.lifecycle.validate()
        if force_incumbent_preprocessor and self.lifecycle.refit_preprocessor:
            # Ring plane: front ends encode with the preprocessor loaded
            # at fork — a refit would skew candidate encode vs serving
            # encode. Forced off, loudly.
            logger.warning(
                "lifecycle.refit_preprocessor forced off: the multi-worker "
                "plane's front ends encode with the fork-time preprocessor"
            )
            self.lifecycle.refit_preprocessor = False
        self._clock = clock
        self.policy = TriggerPolicy(self.lifecycle)
        self.reservoir = SampleReservoir(
            self.lifecycle.reservoir_rows, self.lifecycle.dir
        )
        self.reservoir.load()  # resume a prior window if one persists
        self._queue: queue.Queue = queue.Queue(maxsize=_TEE_QUEUE_SLOTS)
        self._lock = threading.Lock()
        self._state = "idle"
        self._shadow: ShadowEngine | None = None
        self._holdout = None
        self._shadow_since = 0.0
        self._mirror_rng_state = 0x9E3779B9  # cheap deterministic LCG
        self._drift_triggers = 0
        self._promotions = {"promoted": 0, "rejected": 0, "rolled_back": 0}
        self._shadow_auc_delta: float | None = None
        # Circuit breaker: consecutive UNEXPECTED retrain/shadow/evaluate
        # failures (named LifecycleError skips don't count — those are
        # the loop declining work, already cooldown-throttled) open the
        # breaker for lifecycle.breaker_cooldown_s: triggers neither fire
        # nor accumulate while open, so a persistently broken retrain
        # path cools down instead of hot-looping attempts against live
        # serving. Exported as mlops_tpu_lifecycle_breaker_open /
        # _breaker_trips_total.
        self._consecutive_failures = 0
        self._breaker_open_until = float("-inf")
        self._breaker_trips = 0
        self._tee_drops = 0
        self._last_report: dict | None = None
        # The port's own record of the last candidate built: the retrain's
        # wall and fit seconds and the shadow's warm (``status``).
        self._last_retrain: dict | None = None
        self._last_error = ""
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        engine.set_lifecycle_tee(self._offer)

    # -------------------------------------------------------------- hot tee
    def _offer(self, cat, num) -> None:
        """Engine dispatch-path hook: bounded, non-blocking, never raises
        (a lifecycle bug must not 500 live traffic). Copies the arrays —
        ring-plane callers pass shared-memory slab views that are reused
        the moment the response is released."""
        try:
            self._queue.put_nowait((cat.copy(), num.copy()))
        except queue.Full:
            with self._lock:
                self._tee_drops += 1
        except Exception:  # tpulint: disable=TPU201
            # Defensive breadth IS the contract at this boundary: any
            # unexpected failure (shutdown race, dtype surprise) must
            # cost one observation, never a request.
            logger.exception("lifecycle tee offer failed; observation lost")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="lifecycle", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)
        self.engine.set_lifecycle_tee(None)
        try:
            self.reservoir.save()
        except OSError:
            logger.exception("reservoir snapshot failed on stop")

    def _loop(self) -> None:
        while not self._stop.wait(self.lifecycle.tick_s):
            try:
                self.run_once()
            # The loop must survive anything a tick throws (transient
            # device fetch failure, a retrain crash): log, cool down,
            # RESET to idle — a tick that died mid-transition must not
            # leave the state machine stranded in 'retraining'/'shadowing'
            # (where run_once would no-op forever and the loop silently
            # dies) — and keep serving; the controller can never take the
            # engine down with it.
            except Exception as err:  # tpulint: disable=TPU201
                logger.exception("lifecycle tick failed")
                with self._lock:
                    self._last_error = f"{type(err).__name__}: {err}"
                    self._state = "idle"
                    self._shadow = None
                    self._holdout = None
                self._note_failure(self._clock())
                self.policy.start_cooldown(self._clock())

    # ------------------------------------------------------------- run_once
    def run_once(self, now: float | None = None) -> dict:
        """One controller step: drain observations, then at most one
        state-machine transition. Tests and the bench drive this
        directly; the background loop calls it every tick."""
        now = self._clock() if now is None else now
        self._drain_observations()
        state = self._state
        if state == "idle":
            self._step_idle(now)
        elif state == "shadowing":
            self._step_shadow(now)
        return self.status()

    def _drain_observations(self) -> None:
        """Tee queue -> reservoir (+ mirrored shadow scoring while a
        candidate is shadowing). Runs on the controller thread. BOUNDED
        at one queue-capacity per call: an unthrottled producer can
        refill the queue faster than mirror scoring consumes it, and an
        until-empty drain would livelock ``run_once`` (the state machine
        would never step again) — excess observations wait for the next
        tick or drop at the tee, never wedge the loop."""
        shadow = self._shadow
        mirroring = shadow is not None and self._state == "shadowing"
        for _ in range(_TEE_QUEUE_SLOTS):
            try:
                cat, num = self._queue.get_nowait()
            except queue.Empty:
                return
            self.reservoir.add_batch(cat, num)
            if mirroring and self._mirror_draw():
                try:
                    shadow.mirror(cat, num)
                # A mirror failure is shadow evidence lost, never an
                # outage: count it and keep draining.
                except Exception:  # tpulint: disable=TPU201
                    logger.exception("shadow mirror dispatch failed")
                    shadow.note_drop()

    def _mirror_draw(self) -> bool:
        """Deterministic LCG draw against mirror_fraction (no
        Random/np state shared with anything else)."""
        frac = self.lifecycle.mirror_fraction
        if frac >= 1.0:
            return True
        if frac <= 0.0:
            return False
        self._mirror_rng_state = (
            self._mirror_rng_state * 1103515245 + 12345
        ) & 0x7FFFFFFF
        return (self._mirror_rng_state / 0x80000000) < frac

    # ------------------------------------------------------ circuit breaker
    def breaker_open(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            return now < self._breaker_open_until

    def _note_failure(self, now: float) -> None:
        """One unexpected retrain/shadow/evaluate failure toward the
        breaker threshold; opening resets the streak (the post-cooldown
        loop gets a fresh ``breaker_failures`` budget — half-open)."""
        with self._lock:
            self._consecutive_failures += 1
            if self._consecutive_failures < self.lifecycle.breaker_failures:
                return
            self._consecutive_failures = 0
            self._breaker_trips += 1
            self._breaker_open_until = (
                now + self.lifecycle.breaker_cooldown_s
            )
            trips, cooldown = (
                self._breaker_trips, self.lifecycle.breaker_cooldown_s,
            )
        logger.error(
            "lifecycle circuit breaker OPEN (trip %d): %d consecutive "
            "failures; triggers suspended for %.0fs",
            trips, self.lifecycle.breaker_failures, cooldown,
        )

    def _note_cycle_complete(self) -> None:
        with self._lock:
            self._consecutive_failures = 0

    # ----------------------------------------------------------- idle step
    def _step_idle(self, now: float) -> None:
        snapshot = self.engine.monitor_snapshot()
        if self.breaker_open(now):
            # Open breaker: the snapshot still advances the differencing
            # baseline (windows stay continuous) through the side-effect-
            # free consume() — observe() here would accumulate hysteresis
            # and arm hidden trigger cooldowns, delaying the documented
            # half-open probe past the breaker window.
            self.policy.consume(snapshot)
            return
        decision = self.policy.observe(snapshot, now)
        if not decision.fired:
            return
        with self._lock:
            self._drift_triggers += 1
            self._state = "retraining"
            self._last_error = ""
        logger.info("lifecycle trigger fired: %s", decision.reason)
        try:
            # Fault point: a raise here is the repeated retrain failure
            # the circuit breaker exists for.
            faults.fire("lifecycle.retrain")
            result = run_retrain(
                self.engine.bundle,
                self.config,
                generation=self.engine.bundle_generation + 1,
                # Attempt-scoped tag: a REJECTED candidate's completed
                # checkpoints must not be resumed by the next trigger
                # (fit would restore the final step and return the same
                # stale params no matter how fresh the labeled window);
                # a crash-restarted attempt still resumes — the counter
                # restarts with the process.
                attempt=self._drift_triggers,
                # The reservoir IS the recent serving window: the
                # candidate's drift reference/outlier detector refit on
                # what traffic actually looks like, not on the labeled
                # file alone.
                reservoir_window=self.reservoir.window(),
                device=self.engine.device,
            )
            shadow = ShadowEngine(self.engine, result.bundle)
            shadow.warm()
        except LifecycleError as err:
            logger.warning("retrain skipped: %s", err)
            with self._lock:
                self._state = "idle"
                self._last_error = str(err)
            self.policy.start_cooldown(now)
            return
        # Breadth is deliberate at this boundary: ANY retrain/warm
        # failure (corrupt labeled file mid-append, OSError on the state
        # dir, a compile failure) must log + cool down + return to idle,
        # never strand the state machine in 'retraining' while the
        # server keeps serving.
        except Exception as err:  # tpulint: disable=TPU201
            logger.exception("retrain/shadow-warm failed; cooling down")
            with self._lock:
                self._state = "idle"
                self._last_error = f"{type(err).__name__}: {err}"
            self._note_failure(now)
            self.policy.start_cooldown(now)
            return
        logger.info(
            "candidate %s built in %.1fs (fit %.2fs; warm: %s %.2fs); shadowing",
            result.candidate_dir, result.wall_s, result.fit_s, shadow.warm_mode,
            shadow.warm_s,
        )
        with self._lock:
            self._last_retrain = {
                "candidate": str(result.candidate_dir),
                "labeled_rows": result.labeled_rows,
                "wall_s": result.wall_s,
                "fit_s": result.fit_s,
                "warm_mode": shadow.warm_mode,
                "warm_s": shadow.warm_s,
            }
            self._shadow = shadow
            # (candidate-encoded, incumbent-encoded) — identical objects
            # unless the preprocessor was refit; each side is graded in
            # the encode configuration it serves.
            self._holdout = (result.holdout, result.holdout_incumbent)
            self._shadow_since = now
            self._state = "shadowing"

    # --------------------------------------------------------- shadow step
    def _step_shadow(self, now: float) -> None:
        shadow = self._shadow
        if shadow is None:  # defensive: state says shadowing, no shadow
            with self._lock:
                self._state = "idle"
            return
        enough = shadow.mirrors >= self.lifecycle.shadow_min_mirrors
        timed_out = (now - self._shadow_since) >= self.lifecycle.shadow_max_s
        if not (enough or timed_out):
            return
        try:
            # Fault point: repeated evaluation failure, the shadow half of
            # the circuit breaker's scenario.
            faults.fire("lifecycle.shadow.evaluate")
            report = shadow.evaluate(*self._holdout)
        # An evaluation that cannot complete (device error mid-holdout)
        # would otherwise retry-fail every tick forever: discard the
        # candidate, cool down, return to idle.
        except Exception as err:  # tpulint: disable=TPU201
            logger.exception("shadow evaluation failed; candidate dropped")
            with self._lock:
                self._last_error = f"{type(err).__name__}: {err}"
                self._shadow = None
                self._holdout = None
                self._state = "idle"
            self._note_failure(now)
            self.policy.start_cooldown(now)
            return
        decision = evaluate_gates(report, self.lifecycle)
        outcome = "rejected"
        if decision.passed and self.lifecycle.auto_promote:
            generation = promote_engine(self.engine, shadow)
            outcome = "promoted"
            logger.info(
                "candidate promoted: generation %d (auc %+0.4f, ece %.4f, "
                "p99 %.2f ms vs %.2f ms, %d mirrors)",
                generation, report.auc_delta, report.ece_candidate,
                report.p99_candidate_ms, report.p99_incumbent_ms,
                report.mirrors,
            )
        else:
            logger.warning(
                "candidate rejected%s: %s",
                "" if decision.passed else " by gates",
                "; ".join(decision.reasons) or "auto_promote disabled",
            )
        with self._lock:
            self._promotions[outcome] += 1
            self._shadow_auc_delta = report.auc_delta
            self._last_report = {
                **{
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in vars(report).items()
                },
                "gates": decision.as_dict(),
                "outcome": outcome,
            }
            self._shadow = None
            self._holdout = None
            self._state = "idle"
        # A completed cycle — promoted OR gate-rejected — is the loop
        # WORKING; only failures feed the breaker streak.
        self._note_cycle_complete()
        self.policy.start_cooldown(now)

    # ------------------------------------------------------------- rollback
    def rollback(self) -> int:
        """One-call rollback of a promoted-then-regressing bundle."""
        generation = rollback_engine(self.engine)
        with self._lock:
            self._promotions["rolled_back"] += 1
        self.policy.start_cooldown(self._clock())
        logger.warning("bundle rolled back: generation %d", generation)
        return generation

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                "state": self._state,
                "generation": int(self.engine.bundle_generation),
                "drift_triggers": self._drift_triggers,
                "promotions": dict(self._promotions),
                "shadow_auc_delta": self._shadow_auc_delta,
                "reservoir_rows": None,  # filled below, outside the lock
                "tee_drops": self._tee_drops,
                "breaker_open": now < self._breaker_open_until,
                "breaker_trips": self._breaker_trips,
                "consecutive_failures": self._consecutive_failures,
                "last_error": self._last_error,
                "last_report": self._last_report,
                "last_retrain": self._last_retrain,
            }

    def metrics_snapshot(self) -> dict:
        """The gauge payload ``/metrics`` renders (``serve/metrics.py
        lifecycle_lines``), pulled per scrape."""
        status = self.status()
        status["reservoir_rows"] = self.reservoir.rows
        return status
