"""One request's span: a trace id plus monotonic stage stamps.

A span is a sequence of (stage-name, monotonic-time) stamps where each
stamp marks the END of the named stage — stage durations are the deltas
between consecutive stamps, so by construction the stages are monotone,
non-overlapping, and sum exactly to the span's wall clock. Stamps may
come from another PROCESS on the same host (the engine half of a ring
request, read back out of the shm slot): ``CLOCK_MONOTONIC`` is shared
across processes on one host, and ``stamp_at`` clamps against the
previous stamp so a microscopic cross-process skew can never manufacture
a negative stage.

Torch-free and lock-free: one request's stamps are only ever written by
the thread currently advancing that request (the stages are sequential),
so a plain list append is the whole synchronization story.
"""

from __future__ import annotations

import time
from typing import Any

# Canonical stage vocabulary, in hot-path order. Not every plane emits
# every stage: the ring plane stitches all seven; the single-process solo
# path has no ring/queue stages; the grouped path folds encode into
# dispatch (the engine encodes inside `dispatch_group`). trace-report
# aggregates whatever stages a span carries.
STAGES = (
    "admission",  # head+body read + pydantic validation
    "encode",  # preprocessor encode (front-end side on the ring plane)
    "queue",  # micro-batcher window + claim wait (single-process grouped)
    "ring_wait",  # shm descriptor queued until the engine collector popped it
    "engine_queue",  # collector claim -> pool thread picked the job up
    "dispatch",  # pad/scatter + device enqueue + async D2H copy start
    "device_fetch",  # blocking host-copy wait + packed-buffer slicing
    "respond",  # completion wait + format_response + socket write
)


class Span:
    """Stamp accumulator for one traced request."""

    __slots__ = ("trace_id", "plane", "worker", "route", "rows", "entry",
                 "t0", "stamps", "abandoned", "tenant", "replica", "tier")

    def __init__(
        self,
        trace_id: str,
        plane: str = "single",
        worker: int = 0,
        route: str = "/predict",
        t0: float | None = None,
        tenant: str = "default",
    ) -> None:
        self.trace_id = trace_id
        self.plane = plane
        self.worker = worker
        self.route = route
        # Engine replica that served the request : stitched in
        # from the shm slot tag on the ring plane; 0 everywhere else
        # (the single-process plane has exactly one engine).
        self.replica = 0
        # Bounded tenant label (tenancy/router.py): rides every
        # span record so trace-report can slice per tenant; "default" for
        # untagged traffic keeps pre-tenancy reports parsing unchanged.
        self.tenant = tenant
        self.rows = 0
        # Compiled-entry key ("bucket_8", "group_16x1") when the engine
        # told us which program served the request; None otherwise.
        self.entry: str | None = None
        # Routed serving tier (serve/tierroute.py — a member of
        # the closed TIERS set) when SLO routing resolved one; None keeps
        # single-tier spans byte-identical to pre-routing records.
        self.tier: str | None = None
        self.t0 = time.monotonic() if t0 is None else t0
        self.stamps: list[tuple[str, float]] = []
        # Set when the request path gave up on this span while a
        # background thread may still be stamping it (a deadline-timed-out
        # engine call keeps running in its executor thread): an abandoned
        # span is NEVER finished/recorded — finish() iterating stamps
        # while another thread appends would corrupt the record, and the
        # single-writer rule above only holds while exactly one thread is
        # advancing the request.
        self.abandoned = False

    def stamp(self, stage: str) -> None:
        """End the named stage NOW (this process's monotonic clock)."""
        self.stamp_at(stage, time.monotonic())

    def stamp_at(self, stage: str, t: float) -> None:
        """End the named stage at an absolute monotonic time — the
        cross-process form (engine-half stamps read from the shm slot).
        Clamped non-decreasing: a stamp can never precede its
        predecessor, so stage durations are >= 0 by construction."""
        last = self.stamps[-1][1] if self.stamps else self.t0
        self.stamps.append((stage, max(float(t), last)))

    def finish(self, status: int) -> dict[str, Any]:
        """Close the span into the JSONL record shape. ``stages`` maps
        stage name -> milliseconds; ``stamps`` keeps the raw offsets (ms
        from span start) for monotonicity audits and ad-hoc queries;
        ``wall_ms`` is last-stamp - start, which equals sum(stages) by
        construction."""
        stages: dict[str, float] = {}
        offsets: list[list[Any]] = []
        prev = self.t0
        for stage, t in self.stamps:
            stages[stage] = stages.get(stage, 0.0) + round((t - prev) * 1e3, 4)
            offsets.append([stage, round((t - self.t0) * 1e3, 4)])
            prev = t
        record: dict[str, Any] = {
            "kind": "span",
            "ts": time.time(),
            "trace_id": self.trace_id,
            "plane": self.plane,
            "worker": self.worker,
            "route": self.route,
            "tenant": self.tenant,
            "replica": int(self.replica),
            "status": int(status),
            "rows": int(self.rows),
            "wall_ms": round((prev - self.t0) * 1e3, 4),
            "stages": stages,
            "stamps": offsets,
        }
        if self.entry is not None:
            record["entry"] = self.entry
        if self.tier is not None:
            record["tier"] = self.tier
        return record
