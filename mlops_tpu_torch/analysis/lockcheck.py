"""Runtime lock sanitizer: instrumented locks + seeded schedule perturbation.

The static layer (`analysis/concurrency.py`) proves what it can see
lexically; the interleavings it cannot see — the micro-batcher's
dispatch/fetch overlap, the pipeline executor's stage threads, engine
warmup racing live traffic — are exercised here instead. Tests swap an
object's real ``threading.Lock``/``Semaphore`` attributes for instrumented
wrappers that

- record per-thread acquisition stacks and assert the DECLARED lock order
  (the same ``TPULINT_LOCK_ORDER`` manifest the static layer reads, so the
  two checks can never disagree about intent) — violations are collected,
  never raised mid-test, so the assertion happens once at the end with the
  full evidence;
- account blocked time per lock (``total_wait_ms``, for a harness that
  reports contention);
- optionally perturb the schedule: a seeded random pre-acquire delay
  shifts thread interleavings run to run, so three seeds explore three
  schedules while the deterministic stage graphs must still produce
  BIT-IDENTICAL outputs (`tests/test_torch_batcher.py`,
  `tests/test_torch_pipeline_exec.py`).

No torch import — usable on any machine, including inside a harness before
a backend exists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import sys
import threading
import time
from typing import Any, Callable, Iterator


@dataclasses.dataclass(frozen=True)
class OrderViolation:
    """One observed out-of-order (or undeclared) acquisition."""

    thread: str
    acquiring: str
    holding: tuple[str, ...]
    note: str

    def __str__(self) -> str:  # readable in pytest assertion output
        return (
            f"[{self.thread}] acquired {self.acquiring!r} while holding "
            f"{self.holding} — {self.note}"
        )


class LockSanitizer:
    """Shared state for a set of instrumented locks: per-thread held
    stacks, declared-order checking, wait accounting, and the seeded
    perturber. ``order`` lists lock names OUTERMOST FIRST (the
    ``TPULINT_LOCK_ORDER`` convention); an empty order disables order
    checking but keeps the accounting."""

    def __init__(
        self,
        order: tuple[str, ...] = (),
        perturb_seed: int | None = None,
        max_perturb_s: float = 0.002,
    ) -> None:
        self._rank = {name: i for i, name in enumerate(order)}
        # Per-thread held stacks in a shared registry (not threading.local):
        # a semaphore permit acquired on one thread and released on another
        # (the two-phase dispatch/fetch handoff) must be POPPABLE from the
        # acquirer's stack, or the stale entry manufactures order
        # violations forever and the stack grows without bound.
        self._stacks: dict[int, list[str]] = {}
        self._meta = threading.Lock()
        self._max_perturb_s = max_perturb_s
        self._rng = (
            random.Random(perturb_seed) if perturb_seed is not None else None
        )
        self.violations: list[OrderViolation] = []
        self.acquired: dict[str, int] = {}
        self.wait_s: dict[str, float] = {}

    # ------------------------------------------------------------- state
    @property
    def total_wait_s(self) -> float:
        with self._meta:
            return sum(self.wait_s.values())

    @property
    def total_wait_ms(self) -> float:
        return self.total_wait_s * 1e3

    # ----------------------------------------------------------- perturb
    def perturb(self) -> None:
        """Seeded random delay (schedule perturbation). The draw is
        serialized (Random is not thread-safe) but the sleep is not — the
        delay itself is what shifts the interleaving."""
        if self._rng is None:
            return
        with self._meta:
            delay = self._rng.random() * self._max_perturb_s
        time.sleep(delay)

    # ------------------------------------------------------------- hooks
    def note_acquire(self, name: str, waited_s: float) -> None:
        with self._meta:
            held = list(
                self._stacks.setdefault(threading.get_ident(), [])
            )
        for holding in held:
            note = None
            if self._rank:
                if name not in self._rank:
                    note = (
                        "lock is not in the declared order "
                        "(TPULINT_LOCK_ORDER) — declare every lock that "
                        "participates in nesting"
                    )
                elif holding in self._rank and (
                    self._rank[name] < self._rank[holding]
                ):
                    note = (
                        "inverts the declared order — a thread taking the "
                        "declared order deadlocks against this one"
                    )
            if note is not None:
                violation = OrderViolation(
                    thread=threading.current_thread().name,
                    acquiring=name,
                    holding=tuple(held),
                    note=note,
                )
                with self._meta:
                    self.violations.append(violation)
        with self._meta:
            self._stacks[threading.get_ident()].append(name)
            self.acquired[name] = self.acquired.get(name, 0) + 1
            self.wait_s[name] = self.wait_s.get(name, 0.0) + waited_s

    def note_release(self, name: str) -> None:
        def pop_innermost(stack: list[str]) -> bool:
            # remove the innermost occurrence (re-entrant/duplicate safe)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    return True
            return False

        ident = threading.get_ident()
        with self._meta:
            own = self._stacks.setdefault(ident, [])
            if pop_innermost(own):
                return
            # Cross-thread release (semaphore handoff): pop the permit from
            # whichever thread's stack still carries it.
            for other, stack in self._stacks.items():
                if other != ident and pop_innermost(stack):
                    return

    # ------------------------------------------------------------- wraps
    def wrap(self, inner: Any, name: str) -> "InstrumentedLock":
        """Wrap any acquire/release primitive (Lock, RLock, Semaphore,
        BoundedSemaphore) — the wrapper is duck-type compatible with all
        of them for the operations this codebase uses."""
        return InstrumentedLock(self, inner, name)


class InstrumentedLock:
    """Duck-typed stand-in for a ``threading`` lock or semaphore: context
    manager + ``acquire``/``release``, reporting into a LockSanitizer."""

    def __init__(self, sanitizer: LockSanitizer, inner: Any, name: str):
        self._san = sanitizer
        self._inner = inner
        self.name = name

    def acquire(self, *args, **kwargs) -> bool:
        self._san.perturb()
        start = time.perf_counter()
        ok = self._inner.acquire(*args, **kwargs)
        waited = time.perf_counter() - start
        if ok:
            self._san.note_acquire(self.name, waited)
        return ok

    def release(self, *args, **kwargs) -> None:
        self._inner.release(*args, **kwargs)
        self._san.note_release(self.name)

    def locked(self) -> bool:  # Lock protocol passthrough
        return self._inner.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def declared_order(obj: Any) -> tuple[str, ...]:
    """The ``TPULINT_LOCK_ORDER`` entry for ``obj``'s class, read from its
    defining module — the single source of truth shared with the static
    layer."""
    module = sys.modules.get(type(obj).__module__)
    manifest = getattr(module, "TPULINT_LOCK_ORDER", {})
    return tuple(manifest.get(type(obj).__name__, ()))


def _lock_attrs(obj: Any) -> list[str]:
    """Attribute names on ``obj`` that quack like THREADING locks or
    semaphores. asyncio primitives (the batcher's dispatch/fetch rings)
    also have acquire/release, but their ``acquire`` is a coroutine — a
    synchronous wrapper would return the coroutine un-awaited, count it as
    a successful acquisition, and leave the permit count untouched, so the
    semaphore would silently stop bounding anything. They are event-loop
    confined anyway; the schedule perturber covers them instead."""
    import inspect

    names = []
    for name, value in vars(obj).items():
        if isinstance(value, InstrumentedLock):
            continue  # never double-wrap
        acquire = getattr(value, "acquire", None)
        if (
            callable(acquire)
            and callable(getattr(value, "release", None))
            and not inspect.iscoroutinefunction(acquire)
        ):
            names.append(name)
    return names


@contextlib.contextmanager
def instrument_locks(
    obj: Any,
    attrs: tuple[str, ...] | None = None,
    order: tuple[str, ...] | None = None,
    perturb_seed: int | None = None,
    max_perturb_s: float = 0.002,
) -> Iterator[LockSanitizer]:
    """Swap ``obj``'s lock attributes for instrumented wrappers for the
    duration of the block; restore the originals on exit. ``attrs``
    defaults to every lock-shaped attribute; ``order`` defaults to the
    module's ``TPULINT_LOCK_ORDER`` declaration for the class. Objects
    with no locks (the sklearn engine flavor) yield a sanitizer that
    simply reports zeros."""
    if attrs is None:
        attrs = tuple(_lock_attrs(obj))
    if order is None:
        order = declared_order(obj)
    sanitizer = LockSanitizer(
        order=order, perturb_seed=perturb_seed, max_perturb_s=max_perturb_s
    )
    saved = {}
    try:
        for name in attrs:
            inner = getattr(obj, name, None)
            if inner is None:
                continue
            saved[name] = inner
            setattr(obj, name, sanitizer.wrap(inner, name))
        yield sanitizer
    finally:
        for name, inner in saved.items():
            setattr(obj, name, inner)


def instrument_engine(
    engine: Any, perturb_seed: int | None = None, max_perturb_s: float = 0.002
):
    """Sugar for the common case: instrument an ``InferenceEngine``'s
    threading locks against its declared order."""
    return instrument_locks(
        engine, perturb_seed=perturb_seed, max_perturb_s=max_perturb_s
    )


class SchedulePerturber:
    """Seeded random delays for schedule-perturbing stress tests: wrap a
    stage function (or call ``sleep()`` at a chosen point) so thread
    interleavings shift run to run while outputs must not."""

    def __init__(self, seed: int, max_delay_s: float = 0.002) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.max_delay_s = max_delay_s

    def sleep(self) -> None:
        with self._lock:
            delay = self._rng.random() * self.max_delay_s
        time.sleep(delay)

    def wrap(self, fn: Callable) -> Callable:
        def perturbed(*args, **kwargs):
            self.sleep()
            return fn(*args, **kwargs)

        return perturbed
