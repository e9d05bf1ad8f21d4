"""Suppression audit: enumerate every ``# tpulint: disable`` and keep it
honest.

A disable comment is a debt note: it asserts "this rule fires here and the
pattern is deliberately safe". When the flagged code is later refactored
away, the comment silently survives — and a stale disable is worse than
none, because it pre-silences the NEXT real violation someone writes on
that line. ``python -m mlops_tpu_torch analyze --list-suppressions`` reports every disable
in the tree with its file:line, rule ids, and live/stale status;
``--fail-stale`` turns stale ones into gating TPU400 findings (the gate
runs it, so every disable stays honest).

Staleness is decided by re-running the suppressible layers (Layer 1 AST
rules + Layer 3 concurrency rules) with suppression filtering OFF and
checking whether any finding lands where the comment applies — the exact
``findings.is_suppressed`` geometry: a trailing comment covers its own
line, a standalone comment line covers the line below. Comments are read
with ``tokenize``, so the disable examples living in docstrings (this
package documents its own syntax) are never mistaken for suppressions.

TPU400 findings are deliberately immune to disable comments: a stale
suppression must not be able to suppress its own staleness report.
"""

from __future__ import annotations

import dataclasses
import io
import tokenize
from pathlib import Path
from typing import Iterable

from mlops_tpu_torch.analysis.astrules import analyze_source, iter_py_files
from mlops_tpu_torch.analysis.concurrency import analyze_concurrency_source
from mlops_tpu_torch.analysis.findings import (
    Finding,
    Severity,
    file_skipped,
    suppressed_rules,
)

STALE_RULE = "TPU400"
STALE_NAME = "stale-suppression"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One ``# tpulint: disable`` comment found in the tree."""

    path: str
    line: int
    rules: frozenset[str]  # empty = bare disable (every rule)
    standalone: bool  # comment-only line (covers the line below too)
    live: bool  # a finding exists that this comment suppresses
    skipped_file: bool = False  # inside a `# tpulint: skip-file` module

    def describe(self) -> str:
        rules = ",".join(sorted(self.rules)) if self.rules else "ALL"
        status = (
            "skip-file"
            if self.skipped_file
            else ("live" if self.live else "STALE")
        )
        return f"{self.path}:{self.line}: disable={rules} [{status}]"


def _comments(source: str) -> list[tuple[int, str, bool]]:
    """(line, text, standalone) for every comment token. tokenize sees
    only real comments — disable examples inside docstrings are STRING
    tokens and never counted."""
    out: list[tuple[int, str, bool]] = []
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            lineno = tok.start[0]
            text = lines[lineno - 1] if lineno <= len(lines) else tok.string
            out.append((lineno, tok.string, text.lstrip().startswith("#")))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # Layer 1 reports the syntax error; nothing to audit here
    return out


def audit_file(
    source: str,
    path: str | Path,
    rel_path: str | Path | None = None,
    extra_findings: Iterable[Finding] = (),
) -> list[Suppression]:
    """Every disable comment in one file, with live/stale resolved against
    a suppression-off run of the suppressible layers. ``extra_findings``
    carries findings from layers that can't re-run per file — Layer 4's
    contract rules are cross-file (one file's manifest governs another's
    write sites), so `audit_paths` computes them project-wide once and
    passes this file's slice in."""
    path = str(path)
    skipped = file_skipped(source)
    raw = [
        (lineno, rules, standalone)
        for lineno, text, standalone in _comments(source)
        if (rules := suppressed_rules(text)) is not None
    ]
    if not raw:
        return []
    if skipped:
        return [
            Suppression(path, lineno, frozenset(rules), standalone,
                        live=False, skipped_file=True)
            for lineno, rules, standalone in raw
        ]
    findings = (
        analyze_source(source, path, rel_path=rel_path, keep_suppressed=True)
        + analyze_concurrency_source(source, path, keep_suppressed=True)
        + list(extra_findings)
    )
    by_line: dict[int, set[str]] = {}
    for f in findings:
        by_line.setdefault(f.line, set()).add(f.rule)

    def covers(lineno: int, rules: set[str], standalone: bool) -> bool:
        lines_covered = [lineno] + ([lineno + 1] if standalone else [])
        for covered in lines_covered:
            fired = by_line.get(covered, set())
            if fired and (not rules or rules & fired):
                return True
        return False

    return [
        Suppression(
            path,
            lineno,
            frozenset(rules),
            standalone,
            live=covers(lineno, rules, standalone),
        )
        for lineno, rules, standalone in raw
    ]


def audit_paths(paths: Iterable[str | Path]) -> list[Suppression]:
    from mlops_tpu_torch.analysis.asyncdiscipline import analyze_async_paths
    from mlops_tpu_torch.analysis.contracts import analyze_contracts_paths

    # Layer-4 and Layer-5 findings are project-wide (cross-file
    # manifests / call graph), so one suppression-off pass each up
    # front, sliced per file below — a disable covering a TPU501-504 or
    # TPU601-604 finding counts as live whether or not the current
    # invocation passed --contracts/--async.
    paths = list(paths)
    project_by_file: dict[str, list[Finding]] = {}
    for finding in analyze_contracts_paths(
        paths, keep_suppressed=True
    ) + analyze_async_paths(paths, keep_suppressed=True):
        project_by_file.setdefault(finding.path, []).append(finding)
    out: list[Suppression] = []
    for file, rel in iter_py_files(paths):
        out.extend(
            audit_file(
                file.read_text(encoding="utf-8"),
                file.as_posix(),
                rel_path=rel.as_posix(),
                extra_findings=project_by_file.get(file.as_posix(), ()),
            )
        )
    return out


def stale_findings(paths: Iterable[str | Path]) -> list[Finding]:
    """Stale suppressions as gating findings (``--fail-stale``)."""
    return [
        Finding(
            rule=STALE_RULE,
            name=STALE_NAME,
            severity=Severity.ERROR,
            path=s.path,
            line=s.line,
            message=(
                "suppression ("
                + (",".join(sorted(s.rules)) if s.rules else "ALL")
                + ") no longer suppresses any finding — the flagged code "
                "moved or was fixed; delete the comment (a stale disable "
                "pre-silences the next real violation on this line)"
            ),
        )
        for s in audit_paths(paths)
        if not s.live and not s.skipped_file
    ]


def format_suppressions(suppressions: list[Suppression]) -> str:
    ordered = sorted(suppressions, key=lambda s: (s.path, s.line))
    stale = sum(1 for s in ordered if not s.live and not s.skipped_file)
    lines = [s.describe() for s in ordered]
    lines.append(
        f"tpulint: {len(ordered)} suppression(s), {stale} stale"
    )
    return "\n".join(lines)
