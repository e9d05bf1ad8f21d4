"""Per-compiled-entry shape histograms: requested vs padded rows.

Every dispatch through a compiled serving program records
``(entry, requested_rows, padded_rows)``: ``bucket_8`` entries pad a
request up to the bucket's rows; ``group_16x1`` entries scatter a
coalesced job into a slots x rows grid. The ratio requested/padded is
the entry's OCCUPANCY — 1.0 means zero padding waste, and the histogram
over it is exactly the live traffic-shape evidence the bucket/geometry
autotuner (``autotune/``) reads (the learned-cost-model line,
PAPERS.md arXiv 2008.01040; goodput accounting, arXiv 2502.06982).

Exported two ways:

- `render_lines()` -> real Prometheus histogram series
  (``mlops_tpu_shape_occupancy_bucket{entry=...,le=...}`` + ``_sum`` /
  ``_count``), per-entry requested/padded row counters, and the derived
  ``mlops_tpu_padding_waste_pct`` / ``mlops_tpu_useful_rows_per_s``
  goodput gauges;
- a fixed-size shm table (`write_table` / `render_table_lines`) so the
  multi-worker plane's ENGINE process (the only one that dispatches) can
  mirror the stats into the ring and any SO_REUSEPORT front end renders
  them on a scrape.

Torch-free; one leaf lock.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# Lock layout: one leaf lock guarding the counter dict; the
# observe() critical section is a handful of float adds (never I/O, never
# a device call).

# Occupancy histogram edges (occupancy = requested/padded is in (0, 1],
# so 1.0 is the +Inf-equivalent top bucket; the explicit +Inf series is
# still emitted — Prometheus histogram_quantile requires it).
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.5, 0.75, 0.9, 1.0)

# shm mirror geometry: entry keys are short ascii ("bucket_16384",
# "group_64x8"); 32 rows cover the warmed grid (6 buckets + 12 group
# geometries) with headroom for novel shapes. Entries past the table
# (pathological novel-shape churn) are dropped from the MIRROR only —
# the engine-side stats keep everything, and trace-report reads those.
TABLE_ROWS = 32
TABLE_KEY_BYTES = 24
TABLE_VALS = 3 + len(OCCUPANCY_BUCKETS)  # dispatches, requested, padded, hist


class ShapeStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # entry -> [dispatches, requested_rows, padded_rows, hist...]
        self._entries: dict[str, list[float]] = {}
        # entry -> shm table row, assigned ONCE on first mirror and never
        # reassigned: a novel entry must not shift existing rows, or a
        # scrape racing the rewrite could pair one entry's key with
        # another entry's counters (a non-monotone _total is a Prometheus
        # counter reset). Entries past the table stay engine-side only.
        self._table_rows: dict[str, int] = {}
        # Entries the shm MIRROR cannot hold (table saturated): updated
        # by write_table, exported as
        # ``mlops_tpu_shape_table_evicted_total`` on both planes.
        # Nonzero means the ring scrape's histograms — and anything fed
        # from them, like the gridtuner's demand reconstruction — are
        # SILENTLY MISSING entries that the engine-side stats still
        # hold; 0 on the single-process plane by construction (it
        # renders the in-memory dict, no mirror, nothing evicted).
        # Monotone: entries only accumulate and row assignment is
        # first-seen-forever, so once the table saturates the overflow
        # set can only grow.
        self._evicted = 0
        # Armed-at monotonic time: the useful_rows_per_s rate base, also
        # mirrored into shm so the ring renderer shares the same base.
        self.t0 = time.monotonic()

    # ------------------------------------------------------------ hot path
    def observe(self, entry: str, requested: int, padded: int) -> None:
        padded = max(int(padded), 1)
        occupancy = min(int(requested) / padded, 1.0)
        bucket = int(np.searchsorted(OCCUPANCY_BUCKETS, occupancy))
        bucket = min(bucket, len(OCCUPANCY_BUCKETS) - 1)
        with self._lock:
            row = self._entries.get(entry)
            if row is None:
                row = self._entries[entry] = [0.0] * TABLE_VALS
            row[0] += 1
            row[1] += requested
            row[2] += padded
            row[3 + bucket] += 1

    def seed(
        self, entries: dict[str, list[float]], t0: float | None = None
    ) -> None:
        """Install a prior engine incarnation's mirrored totals
        : a respawned engine starts its in-memory histograms at
        zero, and re-mirroring absolute zeros over the shm table would
        regress the exported ``_total``/``_bucket`` counters into a
        Prometheus counter reset. Seeding folds the dead incarnation's
        last-published entries back in (first-seen row order preserved)
        and restores the armed-at rate base so ``useful_rows_per_s``
        keeps its denominator across the respawn."""
        with self._lock:
            for entry, vals in entries.items():
                row = self._entries.get(entry)
                if row is None:
                    self._entries[entry] = [float(v) for v in vals]
                else:
                    for i, v in enumerate(vals):
                        row[i] += float(v)
                if entry not in self._table_rows and (
                    len(self._table_rows) < TABLE_ROWS
                ):
                    self._table_rows[entry] = len(self._table_rows)
            if t0 is not None and t0 > 0:
                self.t0 = t0

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> dict[str, list[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._entries.items()}

    def padding_waste_pct(self) -> float:
        """Overall goodput loss to padding: 100 * (1 - requested/padded)
        over every dispatch since the stats armed."""
        snap = self.snapshot()
        requested = sum(v[1] for v in snap.values())
        padded = sum(v[2] for v in snap.values())
        if padded <= 0:
            return 0.0
        return round(100.0 * (1.0 - requested / padded), 3)

    def useful_rows_per_s(self) -> float:
        """Goodput rate: REQUESTED rows (the ones a client asked for —
        padding excluded) per second since the stats armed."""
        snap = self.snapshot()
        requested = sum(v[1] for v in snap.values())
        elapsed = max(time.monotonic() - self.t0, 1e-9)
        return round(requested / elapsed, 1)

    @property
    def evicted_total(self) -> int:
        """Entries the shm mirror has dropped (first-seen 32-row cap):
        the silent-staleness observable. Always 0 until `write_table`
        runs (the single-process plane has no mirror to overflow)."""
        with self._lock:
            return self._evicted

    def render_lines(self) -> list[str]:
        return _lines(
            self.snapshot(), self.useful_rows_per_s(), self.evicted_total
        )

    # ----------------------------------------------------------- shm mirror
    def write_table(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Engine-process single writer: mirror the stats into the ring's
        fixed table (serve/ipc.py ``shape_keys``/``shape_vals``). Row
        assignment is STABLE (first-seen, never reshuffled) so a scrape
        racing this write can never pair entry A's key with entry B's
        counters; within one row, per-cell stores are individually atomic
        and a mid-update mix of one entry's own counters is
        gauge-tolerable (the monitor block's tearing contract). New rows
        write vals BEFORE key — the reader requires both a nonempty key
        and dispatches > 0, so a half-born row is skipped, not misread."""
        with self._lock:
            snap = {k: list(v) for k, v in self._entries.items()}
            for entry in snap:
                if entry not in self._table_rows and (
                    len(self._table_rows) < TABLE_ROWS
                ):
                    self._table_rows[entry] = len(self._table_rows)
            rows = dict(self._table_rows)
            # Overflow accounting: every entry that exists engine-side
            # but holds no mirror row is invisible to ring scrapes (and
            # to the autotuner's demand input) — count them instead of
            # letting a saturated table quietly bias the grid search.
            self._evicted = len(snap) - len(rows)
        for entry, i in rows.items():
            vals[i] = snap[entry]
            raw = entry.encode()[:TABLE_KEY_BYTES]
            key_row = np.zeros(TABLE_KEY_BYTES, np.uint8)
            key_row[: len(raw)] = np.frombuffer(raw, np.uint8)
            keys[i] = key_row


def read_table(keys: np.ndarray, vals: np.ndarray) -> dict[str, list[float]]:
    entries: dict[str, list[float]] = {}
    for i in range(keys.shape[0]):
        if vals[i, 0] <= 0:
            continue
        raw = bytes(keys[i]).rstrip(b"\x00")
        if not raw:
            continue
        entries[raw.decode(errors="replace")] = [float(v) for v in vals[i]]
    return entries


def merge_entries(
    tables: list[dict[str, list[float]]]
) -> dict[str, list[float]]:
    """Fold several replicas' entry tables into one: entries
    are keyed by compiled shape, which every replica warms identically,
    so the fold is a per-key elementwise sum — histogram counts,
    requested/padded totals, and dispatch counts all add."""
    merged: dict[str, list[float]] = {}
    for table in tables:
        for entry, vals in table.items():
            row = merged.get(entry)
            if row is None:
                merged[entry] = [float(v) for v in vals]
            else:
                for i, v in enumerate(vals):
                    row[i] += float(v)
    return merged


def render_table_lines(
    keys: np.ndarray, vals: np.ndarray, elapsed_s: float,
    evicted: int = 0,
) -> list[str]:
    """The ring renderer's half: same series as `ShapeStats.render_lines`
    but from the shm mirror (any front end serves the scrape)."""
    return render_entries_lines(read_table(keys, vals), elapsed_s, evicted)


def render_entries_lines(
    entries: dict[str, list[float]], elapsed_s: float, evicted: int = 0
) -> list[str]:
    """Format an already-merged entry table (the multi-replica render):
    identical series to `render_table_lines`, rate base = the merged
    fleet's oldest armed clock, ``evicted`` = the fleet's summed mirror
    overflow (serve/ipc.py ``shape_evicted``)."""
    requested = sum(v[1] for v in entries.values())
    rate = round(requested / max(elapsed_s, 1e-9), 1)
    return _lines(entries, rate, evicted)


def _lines(
    entries: dict[str, list[float]],
    useful_rows_per_s: float,
    evicted: int = 0,
) -> list[str]:
    """ONE formatting rule for both telemetry planes (the
    `ServingMetrics.robustness_lines` discipline): identical series names
    whether the scrape lands on the single-process server or a ring
    front end."""
    if not entries:
        return []
    lines = ["# TYPE mlops_tpu_shape_occupancy histogram"]
    for entry in sorted(entries):
        row = entries[entry]
        dispatches = int(row[0])
        cumulative = 0
        for j, edge in enumerate(OCCUPANCY_BUCKETS):
            cumulative += int(row[3 + j])
            lines.append(
                f'mlops_tpu_shape_occupancy_bucket{{entry="{entry}",'
                f'le="{edge}"}} {cumulative}'
            )
        lines.append(
            f'mlops_tpu_shape_occupancy_bucket{{entry="{entry}",'
            f'le="+Inf"}} {dispatches}'
        )
        # _sum of observed occupancies is not recoverable from the
        # counters exactly; the mean requested/padded IS the
        # dispatch-weighted occupancy mass, which is what rate queries
        # divide by _count anyway.
        mean = row[1] / max(row[2], 1e-9)
        lines.append(
            f'mlops_tpu_shape_occupancy_sum{{entry="{entry}"}} '
            f"{round(mean * dispatches, 4)}"
        )
        lines.append(
            f'mlops_tpu_shape_occupancy_count{{entry="{entry}"}} {dispatches}'
        )
    lines.append("# TYPE mlops_tpu_requested_rows_total counter")
    for entry in sorted(entries):
        lines.append(
            f'mlops_tpu_requested_rows_total{{entry="{entry}"}} '
            f"{int(entries[entry][1])}"
        )
    lines.append("# TYPE mlops_tpu_padded_rows_total counter")
    for entry in sorted(entries):
        lines.append(
            f'mlops_tpu_padded_rows_total{{entry="{entry}"}} '
            f"{int(entries[entry][2])}"
        )
    requested = sum(v[1] for v in entries.values())
    padded = sum(v[2] for v in entries.values())
    waste = 100.0 * (1.0 - requested / padded) if padded > 0 else 0.0
    lines.append("# TYPE mlops_tpu_padding_waste_pct gauge")
    lines.append(f"mlops_tpu_padding_waste_pct {round(waste, 3)}")
    lines.append("# TYPE mlops_tpu_useful_rows_per_s gauge")
    lines.append(f"mlops_tpu_useful_rows_per_s {useful_rows_per_s}")
    # Mirror-overflow marker (always emitted with the block — the zero
    # baseline keeps chaos-smoke monotonicity checkable): nonzero means
    # these histograms are MISSING entries the engine still tracks, so
    # any consumer — a dashboard, the gridtuner's demand input — is
    # seeing a biased shape distribution.
    lines.append("# TYPE mlops_tpu_shape_table_evicted_total counter")
    lines.append(f"mlops_tpu_shape_table_evicted_total {int(evicted)}")
    return lines
