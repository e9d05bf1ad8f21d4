"""Series registry: static extraction of every ``mlops_tpu_*`` series.

The serving stack renders Prometheus text from TWO independent roots —
the single-process endpoint (`serve/server.py HttpServer._metrics_endpoint`,
composing `ServingMetrics.render()` + the shape/SLO/ledger renderers) and
the shm-ring endpoint (`serve/frontend.py FrontendServer._metrics_endpoint`
-> `render_ring_metrics`). Dashboards and the shipped alert rules
(`configs/alerts/*.yml`) reference series by NAME, so a series that one
renderer emits and the other silently dropped is an outage that only shows
up as a flatlined panel. This module rebuilds the series surface from the
source itself: f-strings in every function reachable from each declared
plane root are reconstructed (formatted values become ``\\x00``
placeholders), scanned for ``# TYPE`` declarations, ``name{label="..."}``
emissions and bare-name emissions, and folded into one registry the
Layer-4 contract rules (TPU502, `analysis/contracts.py`) consume.

Declarations are plain literals in the renderer module (`serve/metrics.py`),
read from source and never imported:

    TPULINT_SERIES_PLANES = {
        "single": ("HttpServer._metrics_endpoint",),
        "ring": ("FrontendServer._metrics_endpoint",),
    }
    TPULINT_PLANE_ONLY_SERIES = {"ring": ("mlops_tpu_ring_depth", ...)}
    TPULINT_BOUNDED_LABELS = ("route", "status", "tenant", ...)

``TPULINT_SERIES_PLANES`` maps a plane name to its root qualnames
(``Class.method`` or a bare function name). Reachability is a leaf-name
call closure: deliberately over-approximate (any ``.render()`` call links
to every ``render`` definition in the project), which errs toward seeing a
series on MORE planes, never toward inventing a missing one.
``TPULINT_PLANE_ONLY_SERIES`` is the declared allowlist for series that
legitimately exist on one plane. ``TPULINT_BOUNDED_LABELS`` names the
label KEYS whose runtime values come from closed sets — a formatted label
value under any other key is unbounded cardinality (TPU502).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

SERIES_PLANES_NAME = "TPULINT_SERIES_PLANES"
PLANE_ONLY_NAME = "TPULINT_PLANE_ONLY_SERIES"
BOUNDED_LABELS_NAME = "TPULINT_BOUNDED_LABELS"

# A formatted value inside a reconstructed f-string. NUL can't appear in
# real source text, so it is an unambiguous "dynamic here" marker.
PLACEHOLDER = "\x00"

_TYPE_RE = re.compile(r"# TYPE (mlops_tpu_\w+) (\w+)")
_NAME_RE = re.compile(r"mlops_tpu_\w+")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')
# Histogram component suffixes: documented under the base series name.
_COMPONENT_RE = re.compile(r"_(?:bucket|sum|count)$")


def module_literals(tree: ast.Module, names: set[str]) -> dict[str, object]:
    """Module-level ``NAME = <literal>`` / ``NAME: t = <literal>``
    declarations, by name. Non-literal values are ignored rather than
    raised — a manifest the analyzer can't read is treated as absent."""
    out: dict[str, object] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value_node = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value_node = node.target, node.value
        else:
            continue
        if not isinstance(target, ast.Name) or target.id not in names:
            continue
        try:
            out[target.id] = ast.literal_eval(value_node)
        except (ValueError, SyntaxError):
            continue
    return out


@dataclasses.dataclass
class SeriesInfo:
    """One series name as the registry sees it across both planes."""

    name: str
    planes: set[str] = dataclasses.field(default_factory=set)
    labels: set[str] = dataclasses.field(default_factory=set)
    prom_type: str | None = None
    # First emission site per plane, insertion-ordered: (path, line).
    sites: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    # Formatted label values: (path, line, label_key).
    dynamic_labels: list[tuple[str, int, str]] = dataclasses.field(
        default_factory=list
    )

    @property
    def base_name(self) -> str:
        return _COMPONENT_RE.sub("", self.name)


@dataclasses.dataclass
class SeriesRegistry:
    planes: dict[str, tuple[str, ...]]  # plane -> declared root qualnames
    plane_only: dict[str, set[str]]  # plane -> allowlisted series names
    bounded_labels: set[str]
    series: dict[str, SeriesInfo]
    manifest_site: tuple[str, int]  # where TPULINT_SERIES_PLANES lives

    def names(self) -> set[str]:
        return set(self.series)


@dataclasses.dataclass
class _FuncInfo:
    qualname: str
    path: str
    # (line, reconstructed text) for strings mentioning mlops_tpu_.
    strings: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    calls: set[str] = dataclasses.field(default_factory=set)  # leaf names


def _docstring_value_ids(tree: ast.Module) -> set[int]:
    ids: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = getattr(node, "body", [])
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                ids.add(id(body[0].value))
    return ids


def _leaf_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _reconstruct(node: ast.AST) -> str | None:
    """The string a Constant/JoinedStr evaluates to, with every formatted
    value replaced by the placeholder. Adjacent plain literals were already
    merged by the parser; a plain+f-string mix is one JoinedStr."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: list[str] = []
        for piece in node.values:
            if isinstance(piece, ast.Constant) and isinstance(
                piece.value, str
            ):
                parts.append(piece.value)
            else:
                parts.append(PLACEHOLDER)
        return "".join(parts)
    return None


def extract_functions(
    tree: ast.Module, path: str
) -> dict[str, _FuncInfo]:
    """Every module-level function and method, with its series-bearing
    strings and called leaf names. Nested defs are attributed to their
    enclosing function — they run (if at all) as part of it."""
    doc_ids = _docstring_value_ids(tree)
    funcs: dict[str, _FuncInfo] = {}

    def visit(fn: ast.AST, qualname: str) -> None:
        info = funcs.setdefault(qualname, _FuncInfo(qualname, path))
        fragment_ids: set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.JoinedStr):
                fragment_ids.update(id(v) for v in node.values)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                leaf = _leaf_name(node.func)
                if leaf:
                    info.calls.add(leaf)
            if id(node) in doc_ids or id(node) in fragment_ids:
                continue
            text = _reconstruct(node)
            if text and "mlops_tpu_" in text:
                info.strings.append((node.lineno, text))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit(node, node.name)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit(item, f"{node.name}.{item.name}")
    return funcs


def _closure(
    roots: tuple[str, ...], funcs: dict[str, _FuncInfo]
) -> list[str]:
    """Qualnames reachable from ``roots`` through the leaf-name call
    graph, in BFS order (so first-seen emission sites are rootmost)."""
    leaf_index: dict[str, list[str]] = {}
    for qual in funcs:
        leaf_index.setdefault(qual.rsplit(".", 1)[-1], []).append(qual)
    seen: list[str] = []
    seen_set: set[str] = set()
    queue: list[str] = []
    for root in roots:
        if root in funcs:
            queue.append(root)
        else:
            queue.extend(leaf_index.get(root.rsplit(".", 1)[-1], []))
    while queue:
        qual = queue.pop(0)
        if qual in seen_set:
            continue
        seen_set.add(qual)
        seen.append(qual)
        for leaf in sorted(funcs[qual].calls):
            queue.extend(leaf_index.get(leaf, []))
    return seen


def _scan_text(text: str):
    """(name, prom_type, labels {key: dynamic}) per series occurrence."""
    typed: dict[str, str] = {}
    for m in _TYPE_RE.finditer(text):
        typed[m.group(1)] = m.group(2)
    for m in _NAME_RE.finditer(text):
        name, end = m.group(0), m.end()
        labels: dict[str, bool] = {}
        if end < len(text) and text[end] == "{":
            close = text.find("}", end)
            if close != -1:
                for lm in _LABEL_RE.finditer(text[end + 1 : close]):
                    labels[lm.group(1)] = PLACEHOLDER in lm.group(2)
        yield name, typed.get(name), labels


def build_registry(
    modules: Iterable[tuple[str, ast.Module]],
) -> SeriesRegistry | None:
    """The cross-plane series registry, or ``None`` when no
    ``TPULINT_SERIES_PLANES`` manifest exists in the project (the series
    contract is opt-in by declaration, like the lock-order manifest)."""
    modules = list(modules)
    planes: dict[str, tuple[str, ...]] = {}
    plane_only: dict[str, set[str]] = {}
    bounded: set[str] = set()
    manifest_site: tuple[str, int] | None = None
    funcs: dict[str, _FuncInfo] = {}
    for path, tree in modules:
        literals = module_literals(
            tree, {SERIES_PLANES_NAME, PLANE_ONLY_NAME, BOUNDED_LABELS_NAME}
        )
        value = literals.get(SERIES_PLANES_NAME)
        if isinstance(value, dict):
            for plane, roots in value.items():
                planes[str(plane)] = tuple(
                    roots if isinstance(roots, (tuple, list)) else (roots,)
                )
            manifest_site = (path, 1)
        value = literals.get(PLANE_ONLY_NAME)
        if isinstance(value, dict):
            for plane, names in value.items():
                plane_only.setdefault(str(plane), set()).update(names)
        value = literals.get(BOUNDED_LABELS_NAME)
        if isinstance(value, (tuple, list, set)):
            bounded.update(str(v) for v in value)
        # Same-leaf collisions across modules: keep both under distinct
        # synthetic keys so neither plane loses reachable emissions.
        for qual, info in extract_functions(tree, path).items():
            key = qual
            while key in funcs:
                key = f"{key}@{len(funcs)}"
            funcs[key] = info
    if not planes or manifest_site is None:
        return None

    registry = SeriesRegistry(
        planes=planes,
        plane_only=plane_only,
        bounded_labels=bounded,
        series={},
        manifest_site=manifest_site,
    )
    for plane, roots in sorted(planes.items()):
        for qual in _closure(roots, funcs):
            info = funcs[qual]
            for line, text in info.strings:
                for name, prom_type, labels in _scan_text(text):
                    entry = registry.series.setdefault(
                        name, SeriesInfo(name)
                    )
                    entry.planes.add(plane)
                    entry.labels.update(labels)
                    if prom_type and entry.prom_type is None:
                        entry.prom_type = prom_type
                    site = (info.path, line)
                    if site not in entry.sites:
                        entry.sites.append(site)
                    for key, dynamic in labels.items():
                        if dynamic:
                            record = (info.path, line, key)
                            if record not in entry.dynamic_labels:
                                entry.dynamic_labels.append(record)
    return registry


def registry_from_paths(
    paths: Iterable[str | Path],
) -> SeriesRegistry | None:
    """Registry over every ``.py`` under ``paths``, for a caller that
    checks alert rules against the renderers actually shipped."""
    from mlops_tpu_torch.analysis.astrules import iter_py_files
    from mlops_tpu_torch.analysis.findings import file_skipped

    modules: list[tuple[str, ast.Module]] = []
    for file, _rel in iter_py_files(paths):
        source = file.read_text(encoding="utf-8")
        if file_skipped(source):
            continue
        try:
            modules.append(
                (file.as_posix(), ast.parse(source, filename=str(file)))
            )
        except SyntaxError:
            continue
    return build_registry(modules)
