"""Per-request SLO tier routing and the brownout-before-shed governor.

A copy of the JAX package's ``serve/tierroute.py``. One engine holds
the default tier it was configured with plus every other gated tier the
bundle admits, and each request carries an SLO class chosen at
admission:

- ``x-slo-class: cheap|default|accurate`` when the client states it;
- otherwise a ``x-request-deadline-ms`` budget at or under
  ``serve.slo_cheap_deadline_ms`` routes ``cheap`` (the cheapest tier
  that can still meet the deadline should serve it);
- otherwise ``default``.

The engine maps class -> tier (``InferenceEngine.route_tier``) at
dispatch. Brownout before shed: while admission pressure (live
occupancy of the in-flight capacity) is past ``brownout_demote_depth``,
the governor demotes ``default``-class requests to ``cheap``;
``accurate`` is never demoted. Restoration has hysteresis
(``brownout_restore_depth`` < demote depth), so the switch cannot flap
at the threshold.
"""

from __future__ import annotations

# SLO classes, in the JAX package's wire order.
SLO_CLASSES = ("default", "cheap", "accurate")
SLO_DEFAULT, SLO_CHEAP, SLO_ACCURATE = 0, 1, 2
_CLASS_BY_NAME = {name: i for i, name in enumerate(SLO_CLASSES)}

# Every serving tier an engine can hold, cheapest -> most accurate: the
# quant student, the gbm tensorization (the sklearn floor's exact bits, a
# gbm bundle's only tier), the exact teacher. A closed set, so the
# ``tier`` metric label is bounded.
TIERS = ("quant", "gbm", "exact")


def parse_slo_class(raw: str) -> int | None:
    """``x-slo-class`` header value -> class index; None when the value
    is not one of the three classes (admission treats an unknown value
    as absent rather than 422ing — the header is advisory routing, not
    part of the scoring payload contract)."""
    return _CLASS_BY_NAME.get(raw.strip().lower())


def resolve_slo_class(
    header: str, deadline_ms: float | None, cheap_deadline_ms: float
) -> int:
    """Admission-time class resolution: an explicit header wins; absent
    that, a deadline budget at or under ``cheap_deadline_ms`` routes
    cheap (a client that can only wait 20 ms has already chosen the
    cheap tier, whether it knows the header or not); everything else is
    default class. ``cheap_deadline_ms <= 0`` disables deadline routing."""
    if header:
        cls = parse_slo_class(header)
        if cls is not None:
            return cls
    if (
        deadline_ms is not None
        and cheap_deadline_ms > 0
        and deadline_ms <= cheap_deadline_ms
    ):
        return SLO_CHEAP
    return SLO_DEFAULT


def tier_for_class(
    ladder: tuple[str, ...], default_tier: str, slo_class: int
) -> str:
    """Class -> tier against one engine's gated ladder (cheapest ->
    most accurate). ``cheap`` takes the ladder floor, ``accurate`` the
    ceiling, ``default`` the engine's configured tier — on a one-tier
    engine all three collapse to the same program, so routing is safe
    to apply unconditionally."""
    if slo_class == SLO_CHEAP:
        return ladder[0]
    if slo_class == SLO_ACCURATE:
        return ladder[-1]
    return default_tier


class BrownoutGovernor:
    """The demote-over-shed switch, one per admission point (the
    server) — intentionally unlocked: the server admits on its one
    asyncio event loop, and the counters are plain int adds.

    ``observe(pressure)`` feeds the current 0..1 occupancy (live inflight
    over capacity) and flips the state with hysteresis; ``route(cls)``
    applies the active state to one request's class. Counters:

    - ``demotions``: requests whose class was demoted (the
      mlops_tpu_tier_demotions_total series)
    - ``brownout_demotions``: the same demotions attributed to the
      brownout switch specifically (mlops_tpu_brownout_demote_total —
      today the only demotion cause, kept as its own counter so a future
      non-brownout demotion cause cannot silently fold in)
    - ``entered`` / ``exited``: state transitions, for the runbook's
      flap check.
    """

    __slots__ = (
        "demote_depth",
        "restore_depth",
        "active",
        "demotions",
        "brownout_demotions",
        "entered",
        "exited",
    )

    def __init__(
        self, demote_depth: float = 0.75, restore_depth: float = 0.5
    ):
        if not 0.0 < demote_depth <= 1.0:
            raise ValueError(
                f"brownout demote depth must be in (0, 1], got {demote_depth}"
            )
        if not 0.0 <= restore_depth < demote_depth:
            raise ValueError(
                "brownout restore depth must be in [0, demote depth) for "
                f"hysteresis, got {restore_depth} vs {demote_depth}"
            )
        self.demote_depth = demote_depth
        self.restore_depth = restore_depth
        self.active = False
        self.demotions = 0
        self.brownout_demotions = 0
        self.entered = 0
        self.exited = 0

    def observe(self, pressure: float) -> bool:
        """Feed the current occupancy fraction; returns the (possibly
        flipped) brownout state. Hysteresis: once active, only dropping
        to ``restore_depth`` deactivates."""
        if self.active:
            if pressure <= self.restore_depth:
                self.active = False
                self.exited += 1
        elif pressure >= self.demote_depth:
            self.active = True
            self.entered += 1
        return self.active

    def route(self, slo_class: int) -> tuple[int, bool]:
        """Apply the CURRENT state (callers ``observe`` first with fresh
        pressure) to one request: under brownout, default class demotes
        to cheap; cheap is already at the floor and accurate is pinned.
        Returns ``(effective class, demoted?)``."""
        if self.active and slo_class == SLO_DEFAULT:
            self.demotions += 1
            self.brownout_demotions += 1
            return SLO_CHEAP, True
        return slo_class, False
