"""ReplicaRouter: the engine replica each ring submit goes to.

A copy of the JAX package's ``replicaset/router.py``. Policy:
least-loaded by live ring depth (the per-(worker, replica)
``rep_inflight`` gauge cells, summed per replica), the lowest index on a
tie, plus per-(tenant, class) affinity on the coalescable small class:
grouped coalescing only pays when concurrent batch-1 requests of one
tenant land on the same replica's collector inside one pop window, so
the small class sticks to its last choice until that replica dies,
un-readies, or falls more than ``affinity_slack`` slots behind the
least-loaded candidate. The large (solo) class has nothing to coalesce
and always takes the least-loaded ready replica.

Dead replicas are routed around (their readiness words in shared memory,
cleared by the supervisor at death): their busy slots replay on the
respawned incarnation while fresh admissions spread over the survivors,
so a ``kill -9`` of one replica is a brownout of 1/E of capacity. With no
replica ready (a full outage, or the first boot) the router still
returns the least-loaded index, so admissions park on a concrete queue
and the first replica to attach answers its share.

One router per ``RingClient``, confined to its worker's event loop: the
sticky map is worker-local, and the only shared reads are single gauge
cells. A stale depth read costs one suboptimal choice, never
correctness: every replica answers every descriptor it is handed.
"""

from __future__ import annotations

from typing import Any

# Slot class 0 is the coalescable small class (serve/ipc.py SMALL), kept
# as a constant here: this module must import without serve/ipc.py, which
# imports it.
_SMALL = 0


class ReplicaRouter:
    def __init__(self, ring: Any, affinity_slack: int = 4) -> None:
        self._ring = ring
        self._replicas = int(ring.replicas)
        self._slack = max(0, int(affinity_slack))
        # (tenant, class) -> the sticky replica of the coalescable class.
        self._sticky: dict[tuple[int, int], int] = {}

    def depth(self, replica: int) -> int:
        """Live ring depth of one replica: slots routed to it and not yet
        released, summed over every front end's gauge cell."""
        return int(self._ring.rep_inflight[:, replica].sum())

    def candidates(self) -> list[int]:
        """The ready replicas, or every replica when none is ready (the
        submit then parks on a concrete queue)."""
        ready = [r for r in range(self._replicas) if self._ring.rep_ready[r]]
        return ready if ready else list(range(self._replicas))

    def route(self, tenant: int, slot_class: int) -> int:
        """The replica of one submit, determined by the gauge state: equal
        depths break toward the lowest index, so two workers reading the
        same state agree."""
        if self._replicas == 1:
            return 0
        candidates = self.candidates()
        depths = {r: self.depth(r) for r in candidates}
        least = min(candidates, key=lambda r: (depths[r], r))
        if slot_class != _SMALL:
            return least
        key = (int(tenant), int(slot_class))
        sticky = self._sticky.get(key)
        if (
            sticky is not None
            and sticky in depths
            and depths[sticky] <= depths[least] + self._slack
        ):
            return sticky
        self._sticky[key] = least
        return least
