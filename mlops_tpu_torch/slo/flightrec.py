"""Flight recorder: a bounded ring of recent evidence, dumped on anomaly.

Every serving process keeps the last ``capacity`` events — request
summaries (status / tenant / latency / request id) and, when tracewire
is armed, finished spans — in memory. When an anomaly trips (a
burn-rate alert firing, an engine respawn, a 5xx/504 spike, a lifecycle
breaker opening) the ring is DUMPED atomically (tmp+rename, the
persistence discipline via `utils.io.atomic_write`) to
``<dir>/flightrec-*.json``, so a post-mortem has the last N seconds of
evidence even after ``kill -9`` of a sibling process — a torn dump can
never land, proven by the same SIGKILL subprocess tests as the other
atomic writers.

Quiet planes write NOTHING: dumps happen only on triggers, a cooldown
bounds dump frequency under a sustained incident, and retention prunes
the directory to the newest ``keep`` files. The SIGTERM/fatal hook
(`dump_if_evidence`) dumps only when the ring actually holds errors or
an alert fired since the last dump — a clean drain leaves a clean
directory (the serve-smoke zero-dump contract).

Torch-free; one leaf lock; the JSON encode and the file write run OUTSIDE
it (no I/O under a lock).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any

from mlops_tpu_torch.utils.io import atomic_write

logger = logging.getLogger("mlops_tpu_torch.slo")

# tpulint Layer-3 manifest (analysis/concurrency.py, read from source):
# the recorder's one leaf lock guards its event ring and dump state.
TPULINT_LOCK_ORDER = {"FlightRecorder": ("_lock",)}


class FlightRecorder:
    def __init__(
        self,
        directory: str | Path,
        capacity: int = 2048,
        cooldown_s: float = 30.0,
        keep: int = 8,
        source: str = "single",
        worker: int = 0,
        spike_errors: int = 8,
        spike_window_s: float = 5.0,
        on_dump=None,
    ) -> None:
        self.dir = Path(directory)
        self.capacity = max(1, int(capacity))
        self.cooldown_s = float(cooldown_s)
        self.keep = max(1, int(keep))
        self.source = source
        self.worker = int(worker)
        self.spike_errors = max(1, int(spike_errors))
        self.spike_window_s = float(spike_window_s)
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._err_times: collections.deque = collections.deque()
        self._last_dump = float("-inf")
        self._evidence = False  # errors/alerts noted since the last dump
        self.dumps = 0  # dump ATTEMPTS (filename sequence)
        self.landed = 0  # dumps that actually hit disk (the exported one)
        self.suppressed = 0  # triggers swallowed by the cooldown
        # Called with the landed path after each successful dump (the
        # ring plane mirrors its dump count into shm through this).
        self._on_dump = on_dump

    # ------------------------------------------------------------ hot path
    def note(self, kind: str, **fields: Any) -> None:
        """Append one event (bounded ring; never blocks, never a syscall)."""
        event = {"kind": kind, "t": time.monotonic(), "ts": time.time()}
        event.update(fields)
        with self._lock:
            self._events.append(event)

    def observe_request(
        self,
        route: str,
        status: int,
        latency_ms: float,
        tenant: str = "default",
        request_id: str = "",
    ) -> None:
        """One request summary. SERVING failures (5xx on ``/predict`` —
        the shed 503 and deadline 504 included) also feed the spike
        detector: reaching ``spike_errors`` failures inside
        ``spike_window_s`` trips a dump even when no burn-rate alert is
        armed to notice. Non-predict 5xx (a readiness probe's 503 while
        the plane warms) are recorded in the ring but are neither spike
        fuel nor drain-time evidence — the same scoping as the
        availability SLO."""
        now = time.monotonic()
        event = {
            "kind": "request",
            "t": now,
            "ts": time.time(),
            "route": route,
            "status": int(status),
            "latency_ms": round(float(latency_ms), 3),
            "tenant": tenant,
        }
        if request_id:
            event["request_id"] = request_id
        spike = False
        with self._lock:
            self._events.append(event)
            if status >= 500 and route == "/predict":
                self._evidence = True
                self._err_times.append(now)
                while (
                    self._err_times
                    and now - self._err_times[0] > self.spike_window_s
                ):
                    self._err_times.popleft()
                if len(self._err_times) >= self.spike_errors:
                    self._err_times.clear()  # re-arm for the next window
                    spike = True
        if spike:
            self.trigger("error_spike")

    def note_span(self, record: dict[str, Any]) -> None:
        """A finished tracewire span record (only when tracing is armed):
        the dump's timeline then names the compiled entry and per-stage
        milliseconds of the offending requests, not just their statuses."""
        with self._lock:
            self._events.append({"kind": "span", "t": time.monotonic(),
                                 **record})

    # ------------------------------------------------------------ triggers
    def note_alert(self, alert: str, tenant: str, severity: str) -> None:
        """An alert transition (the SLO engine's on_alert hook lands
        here, as does a front end watching shm flags): recorded into the
        ring — the dump shows WHEN the alert flipped relative to the
        requests around it — then trips a dump through the cooldown."""
        self.note("alert", alert=alert, tenant=tenant, severity=severity)
        with self._lock:
            self._evidence = True
        self.trigger(f"alert-{alert}")

    def trigger(self, reason: str) -> threading.Thread | None:
        """Anomaly trip: dump unless a dump landed inside the cooldown
        (a sustained incident produces a bounded file stream, not one
        per tick). The write runs on a short-lived DAEMON THREAD — the
        hottest trigger is the 5xx spike, which fires from the request
        path on the asyncio event loop, exactly when the plane is
        already burning; a slow disk must cost a late dump, never
        request tail latency. The cooldown slot is claimed here (so
        concurrent triggers cannot stack dumps) and restored by a
        failed write (`dump`). Returns the writer thread (joinable for
        tests), or None when suppressed."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < self.cooldown_s:
                self.suppressed += 1
                return None
            self._last_dump = now
        writer = threading.Thread(
            target=self.dump, args=(reason,),
            name="flightrec-dump", daemon=True,
        )
        writer.start()
        return writer

    def dump_if_evidence(self, reason: str) -> Path | None:
        """The SIGTERM/fatal hook: dump only when the ring holds actual
        evidence (a 5xx/504 or an alert since the last dump) — a clean
        drain writes nothing, an incident-time drain preserves the tail."""
        with self._lock:
            if not self._evidence:
                return None
        return self.dump(reason)

    # ---------------------------------------------------------------- dump
    def dump(self, reason: str) -> Path | None:
        """Snapshot the ring and write it ATOMICALLY (tmp+rename): a
        reader — or a sibling's kill -9 landing mid-write — never sees a
        torn file; the failed-write temp never leaks
        (`utils.io.atomic_write`). Returns the path, or None when the
        write failed (a full disk costs the dump, never the serving
        path)."""
        with self._lock:
            events = list(self._events)
            self._evidence = False
            self.dumps += 1
            seq = self.dumps
        payload = {
            "kind": "flightrec",
            "reason": reason,
            "ts": time.time(),
            "t": time.monotonic(),
            "pid": os.getpid(),
            "source": self.source,
            "worker": self.worker,
            "events": events,
        }
        name = (
            f"flightrec-{int(payload['ts'] * 1e3)}-p{os.getpid()}"
            f"-{seq}-{_safe(reason)}.json"
        )
        path = self.dir / name
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            atomic_write(path, json.dumps(payload).encode())
            self._prune()
        except OSError:
            # A failed write (full disk, mid-incident — exactly when
            # dumps fire) must neither burn the cooldown slot nor eat
            # the evidence: restore both so the NEXT trigger (or an
            # operator's drain) retries instead of preserving nothing.
            logger.exception("flight-recorder dump failed (%s)", reason)
            with self._lock:
                self._evidence = True
                self._last_dump = float("-inf")
            return None
        logger.warning(
            "flight recorder dumped %d events -> %s (reason: %s)",
            len(events), path, reason,
        )
        with self._lock:
            self.landed += 1
        if self._on_dump is not None:
            self._on_dump(path)
        return path

    def _prune(self) -> None:
        """Retention: keep the newest ``keep`` dumps in the directory
        (fleet-wide — every process prunes the shared dir by mtime)."""
        dumps = sorted(
            self.dir.glob("flightrec-*.json"),
            key=lambda p: p.stat().st_mtime,
            reverse=True,
        )
        for stale in dumps[self.keep:]:
            try:
                stale.unlink()
            except OSError:
                pass  # a sibling pruned it first


def _safe(reason: str) -> str:
    return "".join(
        c if c.isalnum() or c in "-_" else "-" for c in reason
    )[:48] or "trigger"


# ------------------------------------------------------------- CLI render
def load_dump(path: str | Path) -> dict[str, Any]:
    return json.loads(Path(path).read_text())


def format_timeline(dump: dict[str, Any]) -> str:
    """Human timeline of one dump (`python -m mlops_tpu_torch flightrec <dump.json>`):
    events ordered by monotonic time, offsets relative to the dump
    moment (negative = before the dump)."""
    t_dump = float(dump.get("t", 0.0))
    head = (
        f"flightrec dump: reason={dump.get('reason')} "
        f"pid={dump.get('pid')} source={dump.get('source')}"
        f" worker={dump.get('worker')} events={len(dump.get('events', []))}"
    )
    lines = [head]
    for event in sorted(
        dump.get("events", []), key=lambda e: float(e.get("t", 0.0))
    ):
        offset = float(event.get("t", 0.0)) - t_dump
        kind = event.get("kind", "?")
        if kind == "request":
            detail = (
                f"{event.get('route', '?')} {event.get('status', '?')} "
                f"{event.get('latency_ms', '?')}ms "
                f"tenant={event.get('tenant', '?')}"
            )
            if event.get("request_id"):
                detail += f" id={event['request_id']}"
        elif kind == "span":
            stages = event.get("stages") or {}
            top = sorted(stages.items(), key=lambda kv: -kv[1])[:3]
            detail = (
                f"trace={event.get('trace_id', '?')} "
                f"status={event.get('status', '?')} "
                f"entry={event.get('entry', '-')} "
                f"wall={event.get('wall_ms', '?')}ms "
                + " ".join(f"{k}={v}ms" for k, v in top)
            )
        elif kind == "alert":
            detail = (
                f"{event.get('alert', '?')} tenant={event.get('tenant', '?')}"
                f" severity={event.get('severity', '?')}"
            )
        else:
            detail = " ".join(
                f"{k}={v}"
                for k, v in event.items()
                if k not in ("kind", "t", "ts")
            )
        lines.append(f"{offset:+9.3f}s  {kind:>7}  {detail}")
    return "\n".join(lines)
