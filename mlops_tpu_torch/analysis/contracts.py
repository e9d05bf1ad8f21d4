"""Layer 4: cross-process contract analysis.

Layers 1-3 check one file at a time; the bugs this layer finds live
BETWEEN processes and files — a shm field
written by a role that doesn't own it, a Prometheus series one renderer
emits and the other dropped, an alert rule referencing a renamed series,
a config knob that validates and is never read, a declared fault point
no chaos test can
fire. This layer analyzes the package as one PROJECT: manifests are
collected from every file first, then every file is evaluated against
them. Pure ``ast`` — like Layers 1 and 3, this module must never import
torch.

======== ============================== =======================================
ID       name                           catches
======== ============================== =======================================
TPU501   shm-ownership                  a shm ring field written from a role
                                        that is not its declared owner
                                        (``TPULINT_SHM_OWNERSHIP``), from a
                                        context with no declared role, or a
                                        ring cell-write to an undeclared field
TPU502   series-contract                a series emitted on one metrics plane
                                        but not the other (outside the
                                        declared single-plane allowlist), an
                                        unbounded (formatted, non-closed-set)
                                        label value, an alert rule referencing
                                        a series absent from the registry, or
                                        a registry series undocumented in
                                        ``docs/observability.md``
TPU503   dead-knob                      a config dataclass field never read
                                        outside the config module's class
                                        bodies (a validated no-op knob)
TPU504   fault-point-liveness           a declared fault point with no
                                        ``faults.fire``/``faults.corrupt``
                                        site, or a site naming an undeclared
                                        point
======== ============================== =======================================

Declarations are plain literals next to the contracts they describe, read
from source and never imported (the Layer-3 manifest discipline):

- ``serve/ipc.py``: ``TPULINT_SHM_OWNERSHIP`` maps each shm field to its
  writer role — a string for single-writer fields, a tuple for a declared
  handoff (every listed role may write). ``TPULINT_SHM_ROLES`` maps
  ``"Class"``, ``"Class.method"`` (most specific wins) or a module-level
  function name to one of the roles. A write participates when its target
  is a CELL write (subscripted or augmented) reached through a receiver
  containing a ``ring`` component, or through ``self`` inside a class
  with any role entry — plain attribute rebinding (view construction in
  ``__init__``) is not a data write. Writes through a local alias
  (``row = ring.mon_vals[r]; row[...] = x``) are invisible to this lexical
  pass; keep aliased writes inside their owning role.
- ``serve/metrics.py``: the series-plane manifests (`analysis/seriesreg.py`
  documents them).
- ``config.py``: ``TPULINT_CONFIG_MODULE = True`` opts the module's
  ``*Config`` dataclasses into TPU503. A field is live when its name is
  read as an attribute (or a literal ``getattr``) anywhere outside the
  config module's dataclass bodies and outside tests.
- ``faults/__init__.py``: the existing ``POINTS`` dict IS the TPU504
  manifest.

Each family only runs when its manifest exists in the analyzed project,
and every finding rides the normal suppression machinery
(``# tpulint: disable=TPU501`` + justification, audited by TPU400).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from mlops_tpu_torch.analysis.findings import (
    Finding,
    Severity,
    file_skipped,
    is_suppressed,
)
from mlops_tpu_torch.analysis.seriesreg import (
    SeriesRegistry,
    build_registry,
    module_literals,
)

SHM_OWNERSHIP_NAME = "TPULINT_SHM_OWNERSHIP"
SHM_ROLES_NAME = "TPULINT_SHM_ROLES"
CONFIG_MODULE_NAME = "TPULINT_CONFIG_MODULE"
FAULT_POINTS_NAME = "POINTS"

_SERIES_TOKEN = re.compile(r"mlops_tpu_\w+")
# Rule/group IDENTIFIER lines in alert yml — a group or alert name is a
# free-form label, not a series reference, even when it matches the
# series prefix (`- name: mlops_tpu_slo_relay` names a group).
_YML_IDENTIFIER_LINE = re.compile(r"^\s*-?\s*(name|alert)\s*:")


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    rule: str
    name: str
    severity: Severity
    summary: str


CONTRACT_RULES: dict[str, RuleInfo] = {
    r.rule: r
    for r in (
        RuleInfo(
            "TPU501",
            "shm-ownership",
            Severity.ERROR,
            "shm field written by a role that does not own it",
        ),
        RuleInfo(
            "TPU502",
            "series-contract",
            Severity.ERROR,
            "metric series breaks the cross-plane/alert/docs contract",
        ),
        RuleInfo(
            "TPU503",
            "dead-knob",
            Severity.ERROR,
            "config dataclass field is never read (validated no-op)",
        ),
        RuleInfo(
            "TPU504",
            "fault-point-liveness",
            Severity.ERROR,
            "fault point declared without a fire site, or fired undeclared",
        ),
    )
}


@dataclasses.dataclass
class _Module:
    path: str
    source: str
    tree: ast.Module
    lines: list[str]


def _parse_project(
    items: Iterable[tuple[str, str]],
) -> list[_Module]:
    modules: list[_Module] = []
    for path, source in items:
        if file_skipped(source):
            continue
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue  # Layer 1 already reports TPU000 for these
        modules.append(_Module(path, source, tree, source.splitlines()))
    return modules


def _flag(
    findings: list[Finding], rule: str, path: str, line: int, message: str
) -> None:
    info = CONTRACT_RULES[rule]
    findings.append(
        Finding(
            rule=info.rule,
            name=info.name,
            severity=info.severity,
            path=path,
            line=line,
            message=message,
        )
    )


# --------------------------------------------------------------- TPU501
def _attr_chain(node: ast.AST) -> tuple[tuple[str, ...], int] | None:
    """Unwrap a write target into (dotted components, subscript depth):
    ``self.ring.shed[w] += 1`` -> (("self", "ring", "shed"), 1). ``None``
    when the target doesn't bottom out in a plain name chain."""
    depth = 0
    while isinstance(node, ast.Subscript):
        depth += 1
        node = node.value
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name) or not parts:
        return None
    parts.append(node.id)
    return tuple(reversed(parts)), depth


def _iter_write_targets(fn: ast.AST):
    """(target, is_aug) for every assignment target inside ``fn``,
    including nested defs (they execute in the same role's process)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                yield target, False
        elif isinstance(node, ast.AugAssign):
            yield node.target, True
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            yield node.target, False


def _check_shm(modules: list[_Module]) -> list[Finding]:
    ownership: dict[str, tuple[str, ...]] = {}
    roles: dict[str, str] = {}
    for mod in modules:
        literals = module_literals(
            mod.tree, {SHM_OWNERSHIP_NAME, SHM_ROLES_NAME}
        )
        value = literals.get(SHM_OWNERSHIP_NAME)
        if isinstance(value, dict):
            for field, owner in value.items():
                ownership[str(field)] = (
                    tuple(str(o) for o in owner)
                    if isinstance(owner, (tuple, list))
                    else (str(owner),)
                )
        value = literals.get(SHM_ROLES_NAME)
        if isinstance(value, dict):
            roles.update({str(k): str(v) for k, v in value.items()})
    if not ownership:
        return []

    findings: list[Finding] = []

    def check_function(
        mod: _Module, fn: ast.AST, cls: str | None
    ) -> None:
        fn_name = fn.name
        if cls is not None:
            role = roles.get(f"{cls}.{fn_name}", roles.get(cls))
            context = f"{cls}.{fn_name}"
            class_has_role = cls in roles or any(
                key.startswith(f"{cls}.") for key in roles
            )
        else:
            role = roles.get(fn_name)
            context = fn_name
            class_has_role = False
        for target, is_aug in _iter_write_targets(fn):
            chain = _attr_chain(target)
            if chain is None:
                continue
            parts, depth = chain
            receiver, field = parts[:-1], parts[-1]
            if not (depth > 0 or is_aug):
                continue  # plain rebinding: view construction, not data
            through_ring = "ring" in receiver
            through_self = receiver == ("self",) and class_has_role
            if not (through_ring or through_self):
                continue
            line = target.lineno
            if field in ownership:
                owners = ownership[field]
                if role is None:
                    _flag(
                        findings,
                        "TPU501",
                        mod.path,
                        line,
                        f"shm field {field!r} (owner: "
                        f"{'/'.join(owners)}) written from {context}, "
                        f"which has no declared role — add it to "
                        f"{SHM_ROLES_NAME} or move the write into its "
                        "owning role",
                    )
                elif role not in owners:
                    _flag(
                        findings,
                        "TPU501",
                        mod.path,
                        line,
                        f"shm field {field!r} is owned by "
                        f"{'/'.join(owners)} but written from {context} "
                        f"(role {role!r}) — a second writer races the "
                        "owner; declare a handoff tuple in "
                        f"{SHM_OWNERSHIP_NAME} only if the protocol "
                        "really passes ownership",
                    )
            elif through_ring:
                _flag(
                    findings,
                    "TPU501",
                    mod.path,
                    line,
                    f"ring cell-write to undeclared shm field {field!r} "
                    f"from {context} — every shared-memory field needs an "
                    f"owner in {SHM_OWNERSHIP_NAME}",
                )

    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                check_function(mod, node, None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        check_function(mod, item, node.name)
    return findings


# --------------------------------------------------------------- TPU502
def _aux_roots(
    paths: Iterable[str | Path],
) -> tuple[list[Path], Path | None]:
    """(alert rule files, observability doc) discovered near the analyzed
    paths: ``configs/alerts/*.yml`` and ``docs/observability.md`` at the
    path itself or up to two parents (the repo layout whether the gate
    analyzes ``mlops_tpu/`` from the root or the package by absolute
    path), plus any yml directly under an analyzed directory (fixtures)."""
    alert_files: list[Path] = []
    docs_file: Path | None = None
    seen: set[str] = set()

    def add_alerts(directory: Path) -> None:
        for pattern in ("*.yml", "*.yaml"):
            for file in sorted(directory.glob(pattern)):
                key = file.resolve().as_posix()
                if key not in seen:
                    seen.add(key)
                    alert_files.append(file)

    for p in paths:
        p = Path(p)
        resolved = p.resolve()
        for base in (resolved, *list(resolved.parents)[:2]):
            alerts_dir = base / "configs" / "alerts"
            if alerts_dir.is_dir():
                add_alerts(alerts_dir)
            doc = base / "docs" / "observability.md"
            if docs_file is None and doc.is_file():
                docs_file = doc
        if p.is_dir():
            for pattern in ("*.yml", "*.yaml"):
                for file in sorted(p.rglob(pattern)):
                    key = file.resolve().as_posix()
                    if key not in seen:
                        seen.add(key)
                        alert_files.append(file)
        elif p.suffix in (".yml", ".yaml") and p.is_file():
            key = resolved.as_posix()
            if key not in seen:
                seen.add(key)
                alert_files.append(p)
    return alert_files, docs_file


def _check_series(
    modules: list[_Module],
    registry: SeriesRegistry | None,
    alert_files: list[Path],
    docs_file: Path | None,
    extra_sources: dict[str, str],
) -> list[Finding]:
    if registry is None:
        return []
    findings: list[Finding] = []
    plane_names = sorted(registry.planes)
    # Parity only means something with two or more declared planes.
    if len(plane_names) >= 2:
        for name in sorted(registry.series):
            info = registry.series[name]
            missing = [p for p in plane_names if p not in info.planes]
            if not missing:
                continue
            present = sorted(info.planes)
            allowlisted = any(
                name in registry.plane_only.get(p, set()) for p in present
            )
            if allowlisted:
                continue
            path, line = info.sites[0]
            _flag(
                findings,
                "TPU502",
                path,
                line,
                f"series {name!r} is emitted on the "
                f"{'/'.join(present)} plane but not on "
                f"{'/'.join(missing)} — a scrape of the other endpoint "
                "flatlines its panels; emit it there or declare it in "
                "TPULINT_PLANE_ONLY_SERIES",
            )
    for name in sorted(registry.series):
        info = registry.series[name]
        for path, line, key in info.dynamic_labels:
            if key in registry.bounded_labels:
                continue
            _flag(
                findings,
                "TPU502",
                path,
                line,
                f"label {key!r} on {name!r} takes a formatted value "
                "outside the declared closed sets "
                "(TPULINT_BOUNDED_LABELS) — unbounded label values are "
                "unbounded series cardinality",
            )
    known = registry.names()
    for file in alert_files:
        try:
            text = extra_sources.get(
                file.as_posix(), file.read_text(encoding="utf-8")
            )
        except OSError:
            continue
        for lineno, line in enumerate(text.splitlines(), start=1):
            if _YML_IDENTIFIER_LINE.match(line):
                continue
            for token in _SERIES_TOKEN.findall(line):
                if token in known:
                    continue
                _flag(
                    findings,
                    "TPU502",
                    file.as_posix(),
                    lineno,
                    f"alert rule references series {token!r}, which no "
                    "renderer emits — this expression can never fire; "
                    "fix the name or delete the rule",
                )
    if docs_file is not None:
        try:
            docs_text = docs_file.read_text(encoding="utf-8")
        except OSError:
            docs_text = ""
        for name in sorted(registry.series):
            info = registry.series[name]
            if name in docs_text or info.base_name in docs_text:
                continue
            path, line = info.sites[0]
            _flag(
                findings,
                "TPU502",
                path,
                line,
                f"series {name!r} is emitted but undocumented in "
                f"{docs_file.as_posix()} — operators can't alert on a "
                "series they don't know exists",
            )
    return findings


# --------------------------------------------------------------- TPU503
def _is_dataclass(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        leaf = (
            target.attr
            if isinstance(target, ast.Attribute)
            else getattr(target, "id", None)
        )
        if leaf == "dataclass":
            return True
    return False


def _is_test_path(path: str) -> bool:
    parts = Path(path).parts
    if "fixtures" in parts:
        # Lint-corpus fixtures simulate production code: their reads count
        # even though the corpus lives under tests/.
        return False
    return any(part in ("tests", "test") for part in parts) or Path(
        path
    ).name.startswith("test_")


def _check_knobs(modules: list[_Module]) -> list[Finding]:
    config_modules = [
        mod
        for mod in modules
        if module_literals(mod.tree, {CONFIG_MODULE_NAME}).get(
            CONFIG_MODULE_NAME
        )
        is True
    ]
    if not config_modules:
        return []

    # field name -> [(module, class, line)], declared in config dataclasses.
    fields: dict[str, list[tuple[_Module, str, int]]] = {}
    config_class_nodes: list[tuple[_Module, ast.ClassDef]] = []
    for mod in config_modules:
        for node in mod.tree.body:
            if (
                isinstance(node, ast.ClassDef)
                and node.name.endswith("Config")
                and _is_dataclass(node)
            ):
                config_class_nodes.append((mod, node))
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name
                    ):
                        name = stmt.target.id
                        if name.startswith("_"):
                            continue
                        fields.setdefault(name, []).append(
                            (mod, node.name, stmt.lineno)
                        )
    if not fields:
        return []

    # Reads: Load-context attribute names (plus literal getattr) anywhere
    # outside the config dataclass bodies and outside tests. Name-based on
    # purpose — a collision errs toward "live", never a false dead-knob.
    excluded = {
        id(sub)
        for _mod, cls in config_class_nodes
        for sub in ast.walk(cls)
    }
    reads: set[str] = set()
    for mod in modules:
        if _is_test_path(mod.path):
            continue
        for node in ast.walk(mod.tree):
            if id(node) in excluded:
                continue
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                reads.add(node.attr)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "getattr"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                reads.add(node.args[1].value)

    findings: list[Finding] = []
    for name in sorted(fields):
        if name in reads:
            continue
        for mod, cls, line in fields[name]:
            _flag(
                findings,
                "TPU503",
                mod.path,
                line,
                f"config knob {cls}.{name} is constructed and validated "
                "but never read outside the config module — a setting "
                "that changes nothing; wire it or delete it",
            )
    return findings


# --------------------------------------------------------------- TPU504
def _check_faults(modules: list[_Module]) -> list[Finding]:
    # name -> (module, key line) for every module-level POINTS dict.
    declared: dict[str, tuple[_Module, int]] = {}
    found_manifest = False
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            else:
                continue
            if (
                not isinstance(target, ast.Name)
                or target.id != FAULT_POINTS_NAME
                or not isinstance(value, ast.Dict)
            ):
                continue
            keys = [
                k
                for k in value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            ]
            if not keys or len(keys) != len(value.keys):
                continue  # not a string-keyed fault manifest
            found_manifest = True
            for key in keys:
                declared.setdefault(key.value, (mod, key.lineno))
    if not found_manifest:
        return []

    fired: dict[str, list[tuple[str, int]]] = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr not in ("fire", "corrupt"):
                    continue
                receiver = func.value
                leaf_parts: list[str] = []
                while isinstance(receiver, ast.Attribute):
                    leaf_parts.append(receiver.attr)
                    receiver = receiver.value
                if isinstance(receiver, ast.Name):
                    leaf_parts.append(receiver.id)
                if "faults" not in leaf_parts:
                    continue
            elif isinstance(func, ast.Name):
                if func.id not in ("fire", "corrupt"):
                    continue
            else:
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (
                isinstance(first, ast.Constant)
                and isinstance(first.value, str)
            ):
                continue  # dynamic point name: out of lexical reach
            fired.setdefault(first.value, []).append(
                (mod.path, node.lineno)
            )

    findings: list[Finding] = []
    for name in sorted(declared):
        if name in fired:
            continue
        mod, line = declared[name]
        _flag(
            findings,
            "TPU504",
            mod.path,
            line,
            f"fault point {name!r} is declared but has no "
            "faults.fire/faults.corrupt site — chaos coverage that can "
            "never trigger; add the site or delete the point",
        )
    for name in sorted(fired):
        if name in declared:
            continue
        for path, line in fired[name]:
            _flag(
                findings,
                "TPU504",
                path,
                line,
                f"fault site names undeclared point {name!r} — the "
                f"armed-points registry ({FAULT_POINTS_NAME}) can never "
                "arm it, so this injection is dead code",
            )
    return findings


# ---------------------------------------------------------- entry points
def _analyze_project(
    modules: list[_Module],
    alert_files: list[Path],
    docs_file: Path | None,
    keep_suppressed: bool,
    extra_sources: dict[str, str] | None = None,
) -> list[Finding]:
    extra_sources = extra_sources or {}
    registry = build_registry([(m.path, m.tree) for m in modules])
    findings = (
        _check_shm(modules)
        + _check_series(
            modules, registry, alert_files, docs_file, extra_sources
        )
        + _check_knobs(modules)
        + _check_faults(modules)
    )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if keep_suppressed:
        return findings
    lines_by_path = {m.path: m.lines for m in modules}
    for file in alert_files:
        text = extra_sources.get(file.as_posix())
        if text is None:
            try:
                text = file.read_text(encoding="utf-8")
            except OSError:
                text = ""
        lines_by_path[file.as_posix()] = text.splitlines()
    return [
        f
        for f in findings
        if not is_suppressed(f, lines_by_path.get(f.path, []))
    ]


def analyze_contracts_source(
    source: str, path: str | Path, keep_suppressed: bool = False
) -> list[Finding]:
    """Run every Layer-4 rule over one file as a single-file project —
    the fixture/test entry point. Cross-file contracts obviously see only
    this file's manifests and sites."""
    path = str(path)
    modules = _parse_project([(path, source)])
    if not modules:
        return []
    return _analyze_project(
        modules, alert_files=[], docs_file=None,
        keep_suppressed=keep_suppressed,
    )


def analyze_contracts_paths(
    paths: Iterable[str | Path], keep_suppressed: bool = False
) -> list[Finding]:
    """Layer-4 lint over every ``.py`` under ``paths`` as ONE project,
    plus the alert-rule/doc surfaces discovered next to them."""
    from mlops_tpu_torch.analysis.astrules import iter_py_files

    paths = list(paths)
    items: list[tuple[str, str]] = []
    for file, _rel in iter_py_files(paths):
        items.append((file.as_posix(), file.read_text(encoding="utf-8")))
    modules = _parse_project(items)
    alert_files, docs_file = _aux_roots(paths)
    return _analyze_project(
        modules, alert_files, docs_file, keep_suppressed=keep_suppressed
    )
