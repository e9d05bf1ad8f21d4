"""tpulint for the port: five-layer static analysis of ``mlops_tpu_torch``.

The port's copy of the JAX package's ``analysis/`` (the same rule ids,
the same ``# tpulint: disable=...`` syntax, the same manifests), in
PyTorch's idiom where the idiom differs:

- **Layer 1** (``astrules``): AST rules over the source, torch-free. The
  traced scope is a program ``serve/graphs.py::capture`` records into a
  CUDA graph (the factories of its ``TPULINT_CAPTURED`` manifest): host
  syncs, Python RNG/clocks and Python branches on tensors there, a
  captured program taking a config, plus broad excepts, mutable defaults
  and hot-path programs or kernels not routed through
  ``ops/cuda_build.py`` / ``serve/graphs.py``.
- **Layer 2** (``traces`` + ``entrypoints``): the registered programs
  traced with ``make_fx`` on fake tensors (no device code runs): f64
  leaks, ``_to_copy`` round trips, op sequences that differ across the
  warmup buckets, layout links between the train step and the engine.
- **Layer 3** (``concurrency``): lock order against ``TPULINT_LOCK_ORDER``,
  guard inference, blocking calls under a lock (``blocking``'s table,
  torch's host syncs included), semaphore pairing; its runtime half is
  ``lockcheck``.
- **Layer 4** (``contracts`` + ``seriesreg``): shm field ownership, the
  metric series of both planes, dead config knobs, fault points.
- **Layer 5** (``asyncdiscipline``): event-loop discipline; its runtime
  half is ``loopcheck``, armed on both serving planes by
  ``serve.loop_lag_monitor``.

CLI: ``python -m mlops_tpu_torch analyze [--strict] [--no-trace]
[--numeric] [--concurrency] [--contracts] [--async]
[--list-suppressions] [--fail-stale] [paths ...]`` (``analysis/cli.py``).
"""

from __future__ import annotations

from mlops_tpu_torch.analysis.findings import Finding, Severity, format_findings
from mlops_tpu_torch.analysis.astrules import RULES, analyze_paths, analyze_source
from mlops_tpu_torch.analysis.concurrency import (
    CONCURRENCY_RULES,
    analyze_concurrency_paths,
    analyze_concurrency_source,
)
from mlops_tpu_torch.analysis.contracts import (
    CONTRACT_RULES,
    analyze_contracts_paths,
    analyze_contracts_source,
)
from mlops_tpu_torch.analysis.asyncdiscipline import (
    ASYNC_RULES,
    analyze_async_paths,
    analyze_async_project,
    analyze_async_source,
)

__all__ = [
    "ASYNC_RULES",
    "CONCURRENCY_RULES",
    "CONTRACT_RULES",
    "Finding",
    "RULES",
    "Severity",
    "analyze_async_paths",
    "analyze_async_project",
    "analyze_async_source",
    "analyze_concurrency_paths",
    "analyze_concurrency_source",
    "analyze_contracts_paths",
    "analyze_contracts_source",
    "analyze_paths",
    "analyze_source",
    "format_findings",
]
