"""Deterministic, config-driven fault injection.

The port's copy of the JAX package's ``faults/injector.py``, the same
plans, decisions and traces. Code declares named injection points
(``faults.fire("serve.engine.dispatch")``, ``raw =
faults.corrupt("compilecache.read", raw)``) and a seeded ``FaultPlan``
decides, deterministically, which hits of which points do what:

- ``raise``   — raise a named exception (device error, OSError, ...)
- ``delay``   — sleep ``delay_s`` (an engine stall)
- ``kill``    — SIGKILL this process mid-operation (torn-write proofs)
- ``corrupt`` — flip seeded bits in the bytes passing a read point

A plan is (rules, seed); every point keeps a per-process hit counter and
each decision hashes ``(seed, rule, point, hit_index)`` with blake2b, so
the same plan, seed and hit order give the same injection trace, in this
package and in the JAX package alike. No global RNG is touched.

Arming: ``faults.arm(FaultPlan.from_rules([...], seed=...))`` (tests),
``faults.disarm()``; ``faults.arm(load_plan("chaos.toml"))``; or
``MLOPS_TPU_FAULTS=/path/to/chaos.toml`` in the environment, which arms
at import in every process that imports this module: one variable arms a
whole forked ring plane (supervisor, front ends, engine), of either
package. Disarmed, a point costs one global load and an identity check.
The module imports neither torch nor numpy and starts no thread.

TOML plan format (``[[fault]]`` tables)::

    seed = 42                      # optional top-level plan seed
    [[fault]]
    point = "serve.engine.dispatch"   # exact name or fnmatch glob
    mode = "delay"                    # raise | delay | kill | corrupt
    delay_s = 1.5
    probability = 0.05                # seeded per-hit Bernoulli
    after = 10                        # skip the first N hits
    max_fires = 3                     # then go quiet (omit = forever)
    exc = "FaultInjected"             # raise mode: exception class
    flip_bits = 4                     # corrupt mode: bits flipped
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging
import os
import signal
import threading
import time
import tomllib
from hashlib import blake2b
from pathlib import Path
from typing import Any

logger = logging.getLogger("mlops_tpu_torch.faults")

FAULT_MODES = ("raise", "delay", "kill", "corrupt")

ENV_VAR = "MLOPS_TPU_FAULTS"


class FaultInjected(RuntimeError):
    """The default exception of a ``raise`` rule, named so that logs and
    tests tell an injected failure from a real one."""


# The exception classes a plan may name: a closed set, since the plan
# comes from a file or the environment.
_RAISABLE: dict[str, type[BaseException]] = {
    "FaultInjected": FaultInjected,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "MemoryError": MemoryError,
}


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: where (a point name or glob), what (the mode)
    and when (``after``, ``max_fires`` and ``probability``, all against
    the seeded per-point hit counter, never a clock)."""

    point: str
    mode: str
    probability: float = 1.0
    after: int = 0
    max_fires: int | None = None
    delay_s: float = 0.0
    exc: str = "FaultInjected"
    message: str = ""
    flip_bits: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.mode not in FAULT_MODES:
            raise ValueError(f"fault mode {self.mode!r} not in {FAULT_MODES}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"fault probability {self.probability} outside [0, 1]")
        if self.mode == "raise" and self.exc not in _RAISABLE:
            raise ValueError(f"fault exc {self.exc!r} not in {sorted(_RAISABLE)}")
        if self.after < 0:
            raise ValueError(f"fault after={self.after} must be >= 0")
        if self.max_fires is not None and self.max_fires < 1:
            raise ValueError(f"fault max_fires={self.max_fires} must be >= 1")
        if self.delay_s < 0:
            raise ValueError(f"fault delay_s={self.delay_s} must be >= 0")
        if self.flip_bits < 1:
            raise ValueError(f"fault flip_bits={self.flip_bits} must be >= 1")

    def matches(self, point: str) -> bool:
        return self.point == point or fnmatch.fnmatchcase(point, self.point)


def _decision_hash(seed: int, rule_point: str, point: str, hit: int) -> int:
    """The stable 64-bit decision value of one (rule, point, hit)."""
    digest = blake2b(f"{seed}:{rule_point}:{point}:{hit}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")

# tpulint Layer-3 manifest (analysis/concurrency.py, read from source):
# the plan's one leaf lock guards its hit counters and seeded draws.
TPULINT_LOCK_ORDER = {"FaultPlan": ("_lock",)}


class FaultPlan:
    """Rules, the per-point hit counters and the recorded trace. One leaf
    lock guards the counters and the trace; the actions (sleep, raise,
    kill, bit flips) run outside it."""

    _FIRE_MODES = frozenset({"raise", "delay", "kill"})
    _CORRUPT_MODES = frozenset({"corrupt"})

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: dict[tuple[str, str], int] = {}  # (rule.point, point)
        self._fires: dict[tuple[str, str], int] = {}
        self._trace: list[tuple[str, int, str, str]] = []

    @classmethod
    def from_rules(cls, rules: list[dict[str, Any] | FaultRule], seed: int = 0) -> "FaultPlan":
        return cls([r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules],
                   seed=seed)

    @classmethod
    def from_toml(cls, path: str | Path) -> "FaultPlan":
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        seed = int(doc.get("seed", 0))
        rules = []
        for table in doc.get("fault", []):
            fields = dict(table)
            fields.setdefault("seed", seed)
            rules.append(FaultRule(**fields))
        return cls(rules, seed=seed)

    def _decide(self, point: str, modes: frozenset[str]) -> FaultRule | None:
        """Count the hit and return the rule to apply (already counted as
        fired), or None. Rules of modes this call site cannot act on are
        skipped without counting. Every matching rule's counter advances
        on every hit, so rules schedule independently; the first rule that
        fires takes the action."""
        with self._lock:
            chosen: FaultRule | None = None
            for rule in self.rules:
                if rule.mode not in modes or not rule.matches(point):
                    continue
                key = (rule.point, point)
                hit = self._hits.get(key, 0)
                self._hits[key] = hit + 1
                if chosen is not None or hit < rule.after:
                    continue
                fired = self._fires.get(key, 0)
                if rule.max_fires is not None and fired >= rule.max_fires:
                    continue
                if rule.probability < 1.0:
                    draw = _decision_hash(rule.seed, rule.point, point, hit) / float(1 << 64)
                    if draw >= rule.probability:
                        continue
                self._fires[key] = fired + 1
                self._trace.append((point, hit, rule.point, rule.mode))
                chosen = rule
            return chosen

    def fire(self, point: str) -> None:
        rule = self._decide(point, self._FIRE_MODES)
        if rule is None:
            return
        if rule.mode == "delay":
            logger.warning("fault injected: delay %.3fs at %s", rule.delay_s, point)
            time.sleep(rule.delay_s)
        elif rule.mode == "raise":
            logger.warning("fault injected: raise %s at %s", rule.exc, point)
            raise _RAISABLE[rule.exc](rule.message or f"injected fault at {point}")
        else:  # kill
            logger.warning("fault injected: SIGKILL at %s", point)
            os.kill(os.getpid(), signal.SIGKILL)

    def corrupt(self, point: str, data: bytes) -> bytes:
        if not data:
            return data
        rule = self._decide(point, self._CORRUPT_MODES)
        if rule is None:
            return data
        flipped = bytearray(data)
        n = len(flipped)
        for i in range(rule.flip_bits):
            h = _decision_hash(rule.seed, rule.point, f"{point}#bit", i)
            flipped[h % n] ^= 1 << ((h >> 32) % 8)
        logger.warning("fault injected: %d bit flip(s) in %d bytes at %s",
                       rule.flip_bits, n, point)
        return bytes(flipped)

    def trace(self) -> list[tuple[str, int, str, str]]:
        """(point, hit index, rule point, mode) per injected fault, in
        injection order."""
        with self._lock:
            return list(self._trace)

    def fires(self) -> int:
        with self._lock:
            return len(self._trace)


# The one global the points read: None is disarmed, a FaultPlan armed.
_plan: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    global _plan
    _plan = plan
    logger.warning("fault injection ARMED: %d rule(s), seed %d", len(plan.rules), plan.seed)
    return plan


def disarm() -> None:
    global _plan
    _plan = None


def armed() -> bool:
    return _plan is not None


def active_plan() -> FaultPlan | None:
    return _plan


def fire(point: str) -> None:
    """The point of raise, delay and kill faults; a no-op unless armed."""
    plan = _plan
    if plan is None:
        return
    plan.fire(point)


def corrupt(point: str, data: bytes) -> bytes:
    """The point of bit flips on a read: ``data`` unchanged unless an
    armed corrupt rule matches."""
    plan = _plan
    if plan is None:
        return data
    return plan.corrupt(point, data)


def load_plan(path: str | Path) -> FaultPlan:
    return FaultPlan.from_toml(path)


def _arm_from_env() -> None:
    """Arm from ``MLOPS_TPU_FAULTS`` at import. A broken plan file fails
    loudly: a chaos run that silently tests nothing is worse than one
    that refuses to start."""
    path = os.environ.get(ENV_VAR, "")
    if path:
        arm(FaultPlan.from_toml(path))


_arm_from_env()
