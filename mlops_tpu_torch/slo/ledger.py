"""Per-compiled-entry device-time cost ledger, persisted across runs.

Every packed dispatch through the serving engine accounts
``(entry key, requested rows, padded rows, device-path seconds)`` where
the device-path seconds run from device enqueue to host-copy complete —
the measured per-entry cost the traffic-shape autotuner (ROADMAP
A4; the learned-cost-model line, PAPERS.md arXiv 2008.01040)
fits its model against.

Keys are ``<entry>@<model-fingerprint>`` — the compiled entry's shape
name plus the model-config fingerprint (`model_tag`: the JAX package's
``compilecache/keys.model_fingerprint`` computed the same way, so both
packages key one architecture alike). The fingerprint
is what keeps the ledger honest across lifecycle events: a PROMOTION to
a different architecture serves different programs under the same
shape names, and a REGRID changes the shape names under the same model
— either way the accounting lands in a fresh entry instead of
cross-polluting the old one's averages.

Persistence: the ledger directory holds one ``ledger.json``; totals are
loaded at construction and ACCUMULATED (two serve runs against one dir
produce monotone per-entry device-seconds), flushed atomically
(tmp+rename via `utils.io.atomic_write` — no torn ledger, ever) by a
background thread and on ``close()``.

Exported as ``mlops_tpu_entry_device_seconds_total`` /
``mlops_tpu_entry_cost_ms_per_row`` (+ dispatch/row counters) on both
planes — the multi-worker plane mirrors each replica's totals into a
fixed shm table exactly like the tracewire shape stats — and ranked by
``python -m mlops_tpu_torch trace-report --ledger``.

Torch-free; one leaf lock; JSON encode + file I/O run outside it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from mlops_tpu_torch.utils.io import atomic_write

logger = logging.getLogger("mlops_tpu_torch.slo")


LEDGER_NAME = "ledger.json"


def model_tag(model_config: Any) -> str:
    """The ledger's model dimension: the first 8 hex digits of the
    sha256 of ``["model", <the model config as a dict>]`` in sorted-key
    JSON — the JAX package's ``model_fingerprint(...)[:8]``, so one
    architecture carries the same tag in both packages' ledgers."""
    blob = json.dumps(
        ["model", dataclasses.asdict(model_config)], sort_keys=True,
        default=str,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:8]
LEDGER_VERSION = 1


def _ledger_path(directory: Path, shard: str) -> Path:
    """One file per writer PROCESS: the single-process server (and a
    1-replica engine) own the bare ``ledger.json``; an E-replica fleet
    writes ``ledger-r<k>.json`` per replica so concurrent flushes never
    clobber a sibling's totals — `ledger_report` merges all shards."""
    return directory / (
        f"ledger-{shard}.json" if shard else LEDGER_NAME
    )

# shm mirror geometry (the trace/shapes.py table discipline): row keys
# are "<entry>@<8-hex>" ("group_64x128@abcdef12" = 21 bytes), vals are
# [device_s, dispatches, rows, padded_rows].
TABLE_ROWS = 32
TABLE_KEY_BYTES = 28
TABLE_VALS = 4


class CostLedger:
    def __init__(
        self,
        directory: str | Path,
        flush_interval_s: float = 30.0,
        shard: str = "",
    ) -> None:
        self.dir = Path(directory)
        self.path = _ledger_path(self.dir, shard)
        self._lock = threading.Lock()
        # key -> [device_s, dispatches, rows, padded_rows]
        self._entries: dict[str, list[float]] = {}
        # Stable first-seen shm rows (the ShapeStats rule: never
        # reshuffled, so a scrape racing the mirror can never pair one
        # entry's key with another's counters).
        self._table_rows: dict[str, int] = {}
        self._dirty = False
        self._closed = False
        self.load_errors = 0
        self._load()
        self._wake = threading.Event()
        self._flush_interval_s = max(0.5, float(flush_interval_s))
        self._writer = threading.Thread(
            target=self._run, name="cost-ledger", daemon=True
        )
        self._writer.start()

    def _load(self) -> None:
        """Seed totals from a prior run's file. A corrupt/torn file (only
        reachable by editing it by hand — writes are atomic) is counted
        and starts fresh rather than killing serving."""
        try:
            # Construction-time only (the writer thread starts after),
            # but held anyway: every _entries write sites under _lock.
            doc = json.loads(self.path.read_text())
            with self._lock:
                for key, vals in doc.get("entries", {}).items():
                    self._entries[str(key)] = [
                        float(vals.get("device_s", 0.0)),
                        float(vals.get("dispatches", 0)),
                        float(vals.get("rows", 0)),
                        float(vals.get("padded_rows", 0)),
                    ]
        except FileNotFoundError:
            pass
        except (OSError, ValueError, TypeError):
            self.load_errors += 1
            logger.exception(
                "cost ledger at %s unreadable; starting fresh", self.path
            )

    # ------------------------------------------------------------ hot path
    def observe(
        self,
        entry: str,
        model_tag: str,
        requested_rows: int,
        padded_rows: int,
        device_s: float,
    ) -> None:
        """One dispatch's accounting: a few float adds under a leaf lock
        (the engine's fetch path calls this — never I/O here)."""
        key = f"{entry}@{model_tag}" if model_tag else entry
        with self._lock:
            row = self._entries.get(key)
            if row is None:
                row = self._entries[key] = [0.0, 0.0, 0.0, 0.0]
            row[0] += float(device_s)
            row[1] += 1.0
            row[2] += float(requested_rows)
            row[3] += float(padded_rows)
            self._dirty = True

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> dict[str, list[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._entries.items()}

    def render_lines(self) -> list[str]:
        return render_entry_lines(self.snapshot())

    # ----------------------------------------------------------- persistence
    def flush(self) -> None:
        """Atomic write of the current totals (tmp+rename): a crash —
        this process's or a sibling's kill -9 — never lands a torn
        ledger."""
        with self._lock:
            if not self._dirty:
                return
            snap = {k: list(v) for k, v in self._entries.items()}
            self._dirty = False
        payload = {
            "version": LEDGER_VERSION,
            "written_at": time.time(),
            "entries": {
                key: {
                    "device_s": round(vals[0], 6),
                    "dispatches": int(vals[1]),
                    "rows": int(vals[2]),
                    "padded_rows": int(vals[3]),
                }
                for key, vals in snap.items()
            },
        }
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            atomic_write(
                self.path, json.dumps(payload, indent=1).encode()
            )
        except OSError:
            # A full disk costs this flush; the totals stay in memory and
            # the next interval retries.
            logger.exception("cost ledger flush failed (%s)", self.path)
            with self._lock:
                self._dirty = True

    def _run(self) -> None:
        while not self._wake.wait(self._flush_interval_s):
            self.flush()

    def close(self) -> None:
        """Final flush + writer join. Safe to call twice."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._writer.join(timeout=10)
        self.flush()

    # ------------------------------------------------------------ shm mirror
    def write_table(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Engine-process single writer: mirror into the ring's fixed
        table (stable first-seen rows; vals before key on new rows — the
        trace/shapes.write_table contract)."""
        with self._lock:
            snap = {k: list(v) for k, v in self._entries.items()}
            for key in snap:
                if key not in self._table_rows and (
                    len(self._table_rows) < TABLE_ROWS
                ):
                    self._table_rows[key] = len(self._table_rows)
            rows = dict(self._table_rows)
        for key, i in rows.items():
            vals[i] = snap[key]
            raw = key.encode()[:TABLE_KEY_BYTES]
            key_row = np.zeros(TABLE_KEY_BYTES, np.uint8)
            key_row[: len(raw)] = np.frombuffer(raw, np.uint8)
            keys[i] = key_row


def read_table(keys: np.ndarray, vals: np.ndarray) -> dict[str, list[float]]:
    entries: dict[str, list[float]] = {}
    for i in range(keys.shape[0]):
        if vals[i, 1] <= 0:  # dispatches: the half-born-row guard
            continue
        raw = bytes(keys[i]).rstrip(b"\x00")
        if not raw:
            continue
        entries[raw.decode(errors="replace")] = [float(v) for v in vals[i]]
    return entries


def merge_entries(
    tables: list[dict[str, list[float]]]
) -> dict[str, list[float]]:
    """Fold several replicas' ledger tables (per-key elementwise sum —
    replicas warm identical entries, so the fold is exact)."""
    merged: dict[str, list[float]] = {}
    for table in tables:
        for key, vals in table.items():
            row = merged.get(key)
            if row is None:
                merged[key] = [float(v) for v in vals]
            else:
                for i, v in enumerate(vals):
                    row[i] += float(v)
    return merged


def _split_key(key: str) -> tuple[str, str]:
    entry, _, model = key.partition("@")
    return entry, model


def render_entry_lines(entries: dict[str, list[float]]) -> list[str]:
    """THE ledger exposition block — one formatter for both planes (the
    trace/shapes._lines discipline). ``entry`` carries the shape name,
    ``model`` the fingerprint that keys the compile cache."""
    if not entries:
        return []
    lines = ["# TYPE mlops_tpu_entry_device_seconds_total counter"]
    for key in sorted(entries):
        entry, model = _split_key(key)
        lines.append(
            f'mlops_tpu_entry_device_seconds_total{{entry="{entry}",'
            f'model="{model}"}} {round(entries[key][0], 6)}'
        )
    lines.append("# TYPE mlops_tpu_entry_dispatch_total counter")
    for key in sorted(entries):
        entry, model = _split_key(key)
        lines.append(
            f'mlops_tpu_entry_dispatch_total{{entry="{entry}",'
            f'model="{model}"}} {int(entries[key][1])}'
        )
    lines.append("# TYPE mlops_tpu_entry_rows_total counter")
    for key in sorted(entries):
        entry, model = _split_key(key)
        lines.append(
            f'mlops_tpu_entry_rows_total{{entry="{entry}",'
            f'model="{model}"}} {int(entries[key][2])}'
        )
    lines.append("# TYPE mlops_tpu_entry_cost_ms_per_row gauge")
    for key in sorted(entries):
        entry, model = _split_key(key)
        vals = entries[key]
        cost = 1e3 * vals[0] / vals[2] if vals[2] > 0 else 0.0
        lines.append(
            f'mlops_tpu_entry_cost_ms_per_row{{entry="{entry}",'
            f'model="{model}"}} {round(cost, 6)}'
        )
    return lines


def ledger_report(directory: str | Path) -> dict[str, Any]:
    """`python -m mlops_tpu_torch trace-report --ledger`: the on-disk ledger ranked by
    ``cost_ms_per_row`` (descending — the most expensive entry per
    useful row first, i.e. where a regrid buys the most). Merges every
    shard in the directory (an E-replica fleet writes one per
    replica)."""
    directory = Path(directory)
    merged: dict[str, dict[str, float]] = {}
    for path in sorted(directory.glob("ledger*.json")):
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        for key, vals in doc.get("entries", {}).items():
            row = merged.setdefault(
                key,
                {"device_s": 0.0, "dispatches": 0, "rows": 0,
                 "padded_rows": 0},
            )
            row["device_s"] += float(vals.get("device_s", 0.0))
            row["dispatches"] += int(vals.get("dispatches", 0))
            row["rows"] += int(vals.get("rows", 0))
            row["padded_rows"] += int(vals.get("padded_rows", 0))
    rows = []
    for key, vals in merged.items():
        entry, model = _split_key(key)
        device_s = float(vals.get("device_s", 0.0))
        dispatches = int(vals.get("dispatches", 0))
        n_rows = int(vals.get("rows", 0))
        padded = int(vals.get("padded_rows", 0))
        rows.append(
            {
                "key": key,
                "entry": entry,
                "model": model,
                "device_s": round(device_s, 6),
                "dispatches": dispatches,
                "rows": n_rows,
                "padded_rows": padded,
                "cost_ms_per_row": round(
                    1e3 * device_s / n_rows if n_rows else 0.0, 6
                ),
                "cost_ms_per_dispatch": round(
                    1e3 * device_s / dispatches if dispatches else 0.0, 6
                ),
                "padding_waste_pct": round(
                    100.0 * (1.0 - n_rows / padded) if padded else 0.0, 3
                ),
            }
        )
    rows.sort(key=lambda r: -r["cost_ms_per_row"])
    return {"ledger": str(directory), "entries": rows}


def format_ledger_report(report: dict[str, Any]) -> str:
    lines = [f"ledger: {report['ledger']} ({len(report['entries'])} entries)"]
    for row in report["entries"]:
        lines.append(
            f"  {row['entry']:>16}@{row['model']:<10}"
            f" cost/row {row['cost_ms_per_row']:9.4f} ms"
            f"  device {row['device_s']:9.3f} s"
            f"  dispatches {row['dispatches']:>8}"
            f"  rows {row['rows']:>10}"
            f"  waste {row['padding_waste_pct']:5.1f}%"
        )
    return "\n".join(lines)
