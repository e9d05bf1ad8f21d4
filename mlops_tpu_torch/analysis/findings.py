"""Finding/severity types shared by both analyzer layers — no torch import.

A ``Finding`` is one report line (``file:line: TPU101 [error] message``)
plus enough structure for the CLI to sort, filter, and gate on it. The
inline suppression syntax (``# tpulint: disable=TPU101,TPU202`` on the
flagged line, or a bare ``# tpulint: disable`` for every rule) is resolved
here so Layer 1 and Layer 2 share one implementation.
"""

from __future__ import annotations

import dataclasses
import enum
import re


class Severity(enum.Enum):
    WARNING = "warning"
    ERROR = "error"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # "TPU101"
    name: str  # "host-sync-under-jit"
    severity: Severity
    path: str  # repo-relative file, or "<trace:entry-name>" for Layer 2
    line: int  # 1-based; 0 when the finding has no source anchor
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} "
            f"[{self.severity.value}] {self.message} ({self.name})"
        )

    def gates(self, strict: bool) -> bool:
        """Does this finding fail the run? Errors always; warnings under
        ``--strict`` (the CI mode)."""
        return self.severity is Severity.ERROR or strict


def format_findings(findings: list[Finding]) -> str:
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    return "\n".join(f.format() for f in ordered)


_DISABLE_RE = re.compile(
    r"#\s*tpulint:\s*disable(?:=(?P<rules>[A-Z0-9, ]+))?"
)
_SKIP_FILE_RE = re.compile(r"#\s*tpulint:\s*skip-file")


def suppressed_rules(source_line: str) -> set[str] | None:
    """Rules suppressed by ``source_line``'s trailing comment.

    Returns None when the line carries no tpulint comment, the empty set
    for a bare ``# tpulint: disable`` (= every rule), else the named rules.
    """
    m = _DISABLE_RE.search(source_line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip() for r in rules.split(",") if r.strip()}


def is_suppressed(finding: Finding, source_lines: list[str]) -> bool:
    """Inline suppression: a ``# tpulint: disable[=RULES]`` comment on the
    flagged line, or a STANDALONE comment line directly above it (for
    lines too long to carry a trailing comment), silences the finding. A
    trailing comment on the previous code line does NOT leak downward —
    it belongs to that line's own violation."""
    candidates = [(finding.line, False), (finding.line - 1, True)]
    for lineno, must_be_standalone in candidates:
        if not 1 <= lineno <= len(source_lines):
            continue
        line = source_lines[lineno - 1]
        if must_be_standalone and not line.lstrip().startswith("#"):
            continue
        rules = suppressed_rules(line)
        if rules is not None and (not rules or finding.rule in rules):
            return True
    return False


def file_skipped(source: str) -> bool:
    """``# tpulint: skip-file`` anywhere in the first 5 lines opts a whole
    file out (generated code, vendored snippets)."""
    head = "\n".join(source.splitlines()[:5])
    return _SKIP_FILE_RE.search(head) is not None
