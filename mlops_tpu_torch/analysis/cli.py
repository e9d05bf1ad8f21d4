"""``python -m mlops_tpu_torch analyze``: runs the layers and gates the
exit code.

Exit codes: 0 clean, 1 findings that gate (errors always; warnings too
under ``--strict``), 2 internal analyzer failure or a missing path.
Layers 1, 3, 4 and 5 never import torch; Layer 2 does (skip it with
``--no-trace``), and ``--numeric`` executes. Both run on the card
wherever there is one.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from time import perf_counter

from mlops_tpu_torch.analysis.astrules import analyze_paths
from mlops_tpu_torch.analysis.findings import Finding, Severity, format_findings


def _default_paths() -> list[str]:
    """Lint the installed package when run without paths, from any cwd."""
    return [str(Path(__file__).resolve().parents[1])]


def _device() -> str:
    """Layer 2's fake tensors and the numeric audit live on the card
    wherever there is one, on the CPU only where there is none."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def run_analyze(args: argparse.Namespace) -> int:
    """Exit 2 (usage or analyzer failure) is distinct from 1 (findings):
    a script keying on the gate must not read a typo'd path or an
    analyzer crash as lint violations."""
    try:
        return _run_analyze(args)
    # The boundary that implements the documented exit-code contract:
    # any analyzer crash becomes a visible 2, never a fake 1.
    except Exception as err:  # tpulint: disable=TPU201
        print(f"tpulint: internal analyzer failure: {type(err).__name__}: {err}")
        return 2


def _run_analyze(args: argparse.Namespace) -> int:
    paths = list(getattr(args, "paths", []) or []) or _default_paths()
    strict = bool(getattr(args, "strict", False))
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"tpulint: error: no such path: {', '.join(missing)}")
        return 2

    if getattr(args, "list_suppressions", False):
        # Report mode: the suppression ledger instead of the finding gate.
        from mlops_tpu_torch.analysis.suppressions import (
            audit_paths,
            format_suppressions,
        )

        suppressions = audit_paths(paths)
        print(format_suppressions(suppressions))
        stale = [s for s in suppressions if not s.live and not s.skipped_file]
        return 1 if (stale and getattr(args, "fail_stale", False)) else 0

    # Per-layer wall time, reported under --strict.
    timings: list[tuple[str, float]] = []

    def timed(label: str, fn):
        t0 = perf_counter()
        result = fn()
        timings.append((label, perf_counter() - t0))
        return result

    findings: list[Finding] = timed("layer1", lambda: analyze_paths(paths))
    if getattr(args, "concurrency", False):
        from mlops_tpu_torch.analysis.concurrency import analyze_concurrency_paths

        findings.extend(timed("layer3", lambda: analyze_concurrency_paths(paths)))
    if getattr(args, "contracts", False):
        from mlops_tpu_torch.analysis.contracts import analyze_contracts_paths

        findings.extend(timed("layer4", lambda: analyze_contracts_paths(paths)))
    if getattr(args, "async_rules", False):
        from mlops_tpu_torch.analysis.asyncdiscipline import analyze_async_paths

        findings.extend(timed("layer5", lambda: analyze_async_paths(paths)))
    if getattr(args, "fail_stale", False):
        from mlops_tpu_torch.analysis.suppressions import stale_findings

        # TPU400 findings are immune to disable comments by construction.
        findings.extend(timed("audit", lambda: stale_findings(paths)))

    notes: list[str] = []
    if not getattr(args, "no_trace", False):
        # The command's first torch import.
        from mlops_tpu_torch.analysis.traces import run_trace_checks

        trace_findings, notes = timed(
            "layer2", lambda: run_trace_checks(device=_device()))
        findings.extend(trace_findings)

    if getattr(args, "numeric", False):
        from mlops_tpu_torch.analysis.entrypoints import NumericAuditError, numeric_audit

        try:
            notes.extend(timed("numeric", lambda: numeric_audit(_device())))
        except NumericAuditError as err:
            findings.append(Finding(
                rule="TPU307",
                name="numeric-audit-failure",
                severity=Severity.ERROR,
                path=f"<numeric:{err.entry}>",
                line=0,
                message=str(err),
            ))

    for note in notes:
        print(f"tpulint: {note}")
    if strict and timings:
        spent = " | ".join(f"{label} {secs:.2f}s" for label, secs in timings)
        print(f"tpulint: layer timings: {spent}")
    if findings:
        print(format_findings(findings))
    gating = [f for f in findings if f.gates(strict)]
    print(
        f"tpulint: {len(findings)} finding(s), {len(gating)} gating"
        f"{' (strict)' if strict else ''} over {len(paths)} path(s)"
    )
    return 1 if gating else 0
