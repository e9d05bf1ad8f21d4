"""Per-tenant admission quota: weighted max-min fair, with integer
reservations.

A copy of the JAX package's ``tenancy/quota.py``. A hot tenant at 10x
its share sheds 503s against its own quota while every cold tenant's
capacity stays reachable. One governor per slot class of a ring front
end's partition (the classes are separate physical pools, so fairness
holds in each). The single-process plane has no governor: each tenant's
micro-batcher gets its own slice of the shared executor's bounds
(``serve/server.py``), so a flood queues in the hot tenant's batcher.

- tenant ``i``'s fractional floor is ``C * w_i / sum(w)``; the hard
  guarantee is its integer part: admission up to ``int(floor_i)`` always
  succeeds while capacity physically exists;
- every admission must leave capacity for every other tenant's unmet
  integer floor. Slots are integral: reserving the exact fractions would
  deadlock small pools, and letting a tenant overshoot its fractional
  floor would let flooders starve a cold tenant. The fractional
  remainders are borrowable slack, the integer floors inviolable, and a
  reservation re-arms as its holds release.

A one-tenant fleet skips the governor (its callers build none).
Single-owner state, confined to one front end's event loop: no locks.
"""

from __future__ import annotations


class QuotaGovernor:
    """Admission counters of one capacity pool (one slot class)."""

    __slots__ = ("capacity", "floors", "_reserved", "used")

    def __init__(self, capacity: int, weights: tuple[float, ...]) -> None:
        if capacity < 1:
            raise ValueError(f"quota capacity {capacity} must be >= 1")
        if not weights or any(w <= 0 for w in weights):
            raise ValueError(f"quota weights {weights} must all be > 0")
        total = float(sum(weights))
        self.capacity = int(capacity)
        # The fractional floors are the shares; the reserved floors their
        # integer parts.
        self.floors = tuple(capacity * w / total for w in weights)
        self._reserved = tuple(int(f) for f in self.floors)
        self.used = [0] * len(weights)

    @property
    def total_used(self) -> int:
        return sum(self.used)

    def try_acquire(self, tenant: int) -> str:
        """Admit one request of ``tenant``: ``"ok"`` (admitted; the caller
        releases it later), ``"quota"`` (capacity exists but this tenant's
        share does not cover it: the caller sheds 503 against the tenant's
        own quota and counts it) or ``"full"`` (the pool is exhausted: not
        a quota event; the caller's physical shed answers)."""
        used = self.used
        total = sum(used)
        if total >= self.capacity:
            return "full"
        # One rule, floor and borrow alike: idle capacity less every other
        # tenant's unmet integer reservation must cover this request.
        reserved_others = 0
        for j, floor in enumerate(self._reserved):
            if j != tenant and used[j] < floor:
                reserved_others += floor - used[j]
        if total + 1 + reserved_others <= self.capacity:
            used[tenant] += 1
            return "ok"
        return "quota"

    def release(self, tenant: int) -> None:
        """Return one admitted request's capacity; clamped at zero, so a
        release bug never manufactures quota."""
        if self.used[tenant] > 0:
            self.used[tenant] -= 1
