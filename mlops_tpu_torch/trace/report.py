"""`python -m mlops_tpu_torch trace-report`: p50/p99 per stage per
compiled entry (the port's copy of the JAX package's ``trace/report.py``;
the same input and output formats, so either package reads the other's
span files).

Reads the span JSONL a traced server left behind (``trace.dir`` — one
``spans*.jsonl`` per serving process; the multi-worker plane writes
``spans-w{N}.jsonl`` per front end) and aggregates stage latencies: the
local answer to the reference repo's "query the Log Analytics table"
workflow, for the question its per-request logs could never answer —
*where* did a request spend its time.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from mlops_tpu_torch.trace.span import STAGES
from mlops_tpu_torch.utils.timing import percentile


def load_spans(path: str | Path) -> list[dict[str, Any]]:
    """Every parseable span record under ``path`` — a trace dir (all its
    ``spans*.jsonl``, so a multi-worker plane's per-worker files
    aggregate as ONE trace set with no manual concatenation), a glob
    pattern (``traces/spans-w*.jsonl`` — cross-directory sweeps), or a
    single JSONL file. Non-span records (kind="stage") and torn/garbage
    lines are skipped — the report must work on a file mid-append."""
    import glob as _glob

    raw = str(path)
    path = Path(path)
    if path.is_dir():
        files = sorted(path.glob("spans*.jsonl"))
    elif not path.exists() and any(c in raw for c in "*?["):
        # Glob form — only when the LITERAL path does not exist, so a
        # real directory/file whose name happens to contain bracket
        # characters keeps loading directly instead of being parsed as
        # a character class that matches nothing.
        files = [Path(f) for f in sorted(_glob.glob(raw))]
    else:
        files = [path]
    spans: list[dict[str, Any]] = []
    for file in files:
        try:
            lines = file.read_text().splitlines()
        except OSError:
            continue
        for line in lines:
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(record, dict) and record.get("kind") == "span":
                spans.append(record)
    return spans


def stage_report(spans: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate: (plane, entry) group -> per-stage {p50_ms, p99_ms,
    count} plus wall p50/p99 and request/row counts. Spans without a
    compiled entry (error paths, sheds) group under entry "-"."""
    groups: dict[tuple[str, str], list[dict[str, Any]]] = {}
    for span in spans:
        key = (str(span.get("plane", "?")), str(span.get("entry", "-")))
        groups.setdefault(key, []).append(span)
    out: dict[str, Any] = {"spans": len(spans), "groups": []}
    for (plane, entry), members in sorted(groups.items()):
        stages: dict[str, list[float]] = {}
        walls: list[float] = []
        rows = 0
        for span in members:
            walls.append(float(span.get("wall_ms", 0.0)))
            rows += int(span.get("rows", 0))
            for stage, ms in (span.get("stages") or {}).items():
                stages.setdefault(stage, []).append(float(ms))
        group: dict[str, Any] = {
            "plane": plane,
            "entry": entry,
            "requests": len(members),
            "rows": rows,
            "wall_p50_ms": round(percentile(sorted(walls), 50), 4),
            "wall_p99_ms": round(percentile(sorted(walls), 99), 4),
            "stages": {},
        }
        for stage, values in stages.items():
            values.sort()
            group["stages"][stage] = {
                "p50_ms": round(percentile(values, 50), 4),
                "p99_ms": round(percentile(values, 99), 4),
                "count": len(values),
            }
        out["groups"].append(group)
    return out


def format_report(report: dict[str, Any]) -> str:
    """Human-readable table (the CLI also prints the JSON for scripts)."""
    lines = [f"spans: {report['spans']}"]
    for group in report["groups"]:
        lines.append(
            f"\n[{group['plane']}] entry={group['entry']} "
            f"requests={group['requests']} rows={group['rows']} "
            f"wall p50={group['wall_p50_ms']}ms p99={group['wall_p99_ms']}ms"
        )
        # Canonical hot-path order first, stragglers after.
        ordered = [s for s in STAGES if s in group["stages"]] + [
            s for s in sorted(group["stages"]) if s not in STAGES
        ]
        for stage in ordered:
            stat = group["stages"][stage]
            lines.append(
                f"  {stage:>13}: p50 {stat['p50_ms']:9.3f} ms   "
                f"p99 {stat['p99_ms']:9.3f} ms   n={stat['count']}"
            )
    return "\n".join(lines)
