"""Runtime event-loop-lag sanitizer — asyncdiscipline's dynamic twin.

`analysis/asyncdiscipline.py` proves lexically that no loop-confined
code path makes a blocking call (TPU601–604). This module checks the
same discipline at RUNTIME, the exact split lockcheck.py provides for
concurrency.py: the static layer sees every lexical path, the sanitizer
sees the real interleaving — a callback that blocks only under load, a
C-extension stall the AST can't name, an executor pool starved into
running work inline.

``LoopLagSanitizer`` wraps the running loop's scheduling entry points
(``call_soon`` / ``call_later`` / ``call_at`` / ``call_soon_threadsafe``
— every coroutine step funnels through ``call_soon`` via ``Task.__step``,
so awaits are covered too) and times each callback on the loop thread:

    sanitizer = LoopLagSanitizer(slow_ms=50.0)
    sanitizer.attach(loop)
    ... run traffic ...
    sanitizer.assert_max_lag(100.0)   # raises listing the slow records

Tests use ``instrument_loop`` (the ``instrument_locks`` analog) or
``assert_max_lag``; production arms it via the ``serve.loop_lag_monitor``
knob and drains ``snapshot_ms()`` into the
``mlops_tpu_event_loop_lag_ms`` gauge each /metrics scrape (window max:
"no stall since the last scrape" reads 0.0, and the series always
renders — the absent-series ambiguity is exactly what the always-emit
contract forbids).

``perturb_seed`` delays each callback by a seeded pseudo-random sleep
BEFORE its timing window opens (the SchedulePerturber discipline from
lockcheck): it shifts the loop's interleaving against executor threads
to flush ordering assumptions, without polluting lag attribution.

Like lockcheck, this module is dependency-free and never imports torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
import traceback
from typing import Any, Callable, Iterator

_PATCHED = ("call_soon", "call_later", "call_at", "call_soon_threadsafe")


@dataclasses.dataclass(frozen=True)
class LagRecord:
    """One slower-than-threshold callback execution on the loop thread."""

    label: str  # callback attribution (coroutine / function qualname)
    duration_ms: float
    schedule_site: str | None  # where it was scheduled, if stacks are on

    def __str__(self) -> str:  # pytest-friendly, like OrderViolation
        site = f" (scheduled at {self.schedule_site})" if (
            self.schedule_site
        ) else ""
        return f"{self.label} held the event loop {self.duration_ms:.1f}ms{site}"


def _attribute(callback: Callable[..., Any]) -> str:
    """Best attribution for a loop callback: coroutine qualname for Task
    steps, function qualname otherwise."""
    owner = getattr(callback, "__self__", None)
    get_coro = getattr(owner, "get_coro", None)
    if get_coro is not None:
        try:
            coro = get_coro()
            name = getattr(coro, "__qualname__", None)
            if name:
                return f"task:{name}"
        except (AttributeError, RuntimeError, TypeError):
            pass  # not a Task after all: fall through to the qualname
    return getattr(callback, "__qualname__", None) or repr(callback)


class LoopLagSanitizer:
    """Times every callback the patched loop runs; keeps the window max
    for the gauge, the worst offenders for attribution, and an all-time
    max for ``assert_max_lag``.

    ``slow_ms``: callbacks at or above this are recorded in ``slow``
    (bounded) with attribution. ``capture_stacks`` stores the schedule
    site per callback — test-only, it prices every scheduling call.
    """

    def __init__(
        self,
        slow_ms: float = 50.0,
        capture_stacks: bool = False,
        perturb_seed: int | None = None,
        max_perturb_s: float = 0.002,
        keep: int = 16,
    ) -> None:
        self.slow_ms = float(slow_ms)
        self.capture_stacks = capture_stacks
        self.slow: list[LagRecord] = []
        self.callbacks = 0  # total callbacks timed
        self.max_lag_ms = 0.0  # all-time worst
        self._window_max_ms = 0.0  # worst since last snapshot_ms()
        self._keep = keep
        self._loop: Any = None
        self._saved: dict[str, Callable[..., Any]] = {}
        self._rng = random.Random(perturb_seed) if (
            perturb_seed is not None
        ) else None
        self._max_perturb_s = max_perturb_s

    # ------------------------------------------------------ observation
    def _note(self, duration_ms: float, label: str, site: str | None) -> None:
        self.callbacks += 1
        if duration_ms > self.max_lag_ms:
            self.max_lag_ms = duration_ms
        if duration_ms > self._window_max_ms:
            self._window_max_ms = duration_ms
        if duration_ms >= self.slow_ms:
            self.slow.append(LagRecord(label, duration_ms, site))
            if len(self.slow) > self._keep:
                # keep the worst offenders, not the most recent
                self.slow.sort(key=lambda r: -r.duration_ms)
                del self.slow[self._keep:]

    def snapshot_ms(self) -> float:
        """Worst callback wall time since the previous call, then reset —
        the /metrics gauge semantics: each scrape reads one window's max,
        and a quiet window reads 0.0."""
        value, self._window_max_ms = self._window_max_ms, 0.0
        return value

    def assert_max_lag(self, max_ms: float) -> None:
        """Raise if any callback so far held the loop ``max_ms`` or
        longer, listing the recorded offenders."""
        if self.max_lag_ms < max_ms:
            return
        offenders = "\n  ".join(
            str(r) for r in sorted(self.slow, key=lambda r: -r.duration_ms)
        ) or f"worst callback: {self.max_lag_ms:.1f}ms (below slow_ms, no attribution)"
        raise AssertionError(
            f"event-loop lag {self.max_lag_ms:.1f}ms >= {max_ms:.1f}ms "
            f"across {self.callbacks} callbacks:\n  {offenders}"
        )

    # -------------------------------------------------------- patching
    def _wrap_callback(
        self, callback: Callable[..., Any]
    ) -> Callable[..., Any]:
        if getattr(callback, "_loopcheck_wrapped", False):
            return callback  # rescheduled handle: keep one timing layer
        site = None
        if self.capture_stacks:
            # drop this frame + the patched scheduling frame
            frame = traceback.extract_stack(limit=4)[0]
            site = f"{frame.filename}:{frame.lineno} in {frame.name}"
        label = _attribute(callback)

        def timed(*args: Any) -> Any:
            if self._rng is not None:
                # seeded schedule perturbation, outside the timing window
                time.sleep(self._rng.random() * self._max_perturb_s)
            start = time.perf_counter()
            try:
                return callback(*args)
            finally:
                self._note(
                    (time.perf_counter() - start) * 1e3, label, site
                )

        timed._loopcheck_wrapped = True  # type: ignore[attr-defined]
        return timed

    def attach(self, loop: Any) -> None:
        """Patch ``loop``'s scheduling entry points (instance attributes
        — the loop class stays untouched) so every callback it runs is
        timed. Idempotent per loop; ``detach`` restores."""
        if self._loop is not None:
            raise RuntimeError("sanitizer already attached")
        self._loop = loop
        for name in ("call_soon", "call_soon_threadsafe"):
            original = getattr(loop, name)
            self._saved[name] = original

            def scheduler(
                callback: Callable[..., Any],
                *args: Any,
                _original: Callable[..., Any] = original,
                **kwargs: Any,
            ) -> Any:
                return _original(
                    self._wrap_callback(callback), *args, **kwargs
                )

            setattr(loop, name, scheduler)
        for name in ("call_later", "call_at"):
            original = getattr(loop, name)
            self._saved[name] = original

            def delayed(
                when: float,
                callback: Callable[..., Any],
                *args: Any,
                _original: Callable[..., Any] = original,
                **kwargs: Any,
            ) -> Any:
                return _original(
                    when, self._wrap_callback(callback), *args, **kwargs
                )

            setattr(loop, name, delayed)

    def detach(self) -> None:
        """Restore the loop's original scheduling methods."""
        if self._loop is None:
            return
        for name in _PATCHED:
            original = self._saved.pop(name, None)
            if original is not None:
                # the originals were bound methods; deleting the instance
                # attribute re-exposes them, keeping the loop pristine
                try:
                    delattr(self._loop, name)
                except AttributeError:
                    setattr(self._loop, name, original)
        self._loop = None


@contextlib.contextmanager
def instrument_loop(
    loop: Any,
    slow_ms: float = 50.0,
    capture_stacks: bool = True,
    perturb_seed: int | None = None,
    max_perturb_s: float = 0.002,
) -> Iterator[LoopLagSanitizer]:
    """``instrument_locks``'s loop analog: attach a ``LoopLagSanitizer``
    for the duration of a with-block and always detach, so a failing
    assertion never leaves a patched loop behind."""
    sanitizer = LoopLagSanitizer(
        slow_ms=slow_ms,
        capture_stacks=capture_stacks,
        perturb_seed=perturb_seed,
        max_perturb_s=max_perturb_s,
    )
    sanitizer.attach(loop)
    try:
        yield sanitizer
    finally:
        sanitizer.detach()
