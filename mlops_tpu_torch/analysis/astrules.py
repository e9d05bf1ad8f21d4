"""Layer 1: AST lint rules over the port's source, in PyTorch's idiom.
Pure ``ast``: this module never imports torch, so the lint runs in
milliseconds on any machine.

The JAX package's "traced scope" is a ``jax.jit`` body. The port's is a
program that ``serve/graphs.py::capture`` records into a CUDA graph: the
programs the factories named in ``TPULINT_CAPTURED`` (a manifest in
``serve/graphs.py``) return. A capture records the device work of one
call and replays it; whatever the Python ran on the host at capture time
(a sync, a clock read, a branch taken) is frozen into every replay.

======== ============================== =======================================
ID       name                           catches
======== ============================== =======================================
TPU101   host-sync-under-capture        ``.item()/.tolist()/.cpu()/.numpy()``,
                                        ``torch.cuda.synchronize``, an event's
                                        or stream's ``synchronize``, ``np.
                                        asarray``, ``float(tensor)``, or
                                        ``nonzero``/``argwhere``/one-argument
                                        ``where`` without a ``size`` in a
                                        captured program: a device->host sync,
                                        which a capture cannot record
TPU102   host-rng-or-clock-under-       ``random.*`` / ``np.random.*`` /
         capture                        ``time.*`` in a captured program: read
                                        once at capture, replayed as a constant
TPU103   tensor-branch                  a Python ``if``/``while`` on a tensor
                                        in a captured program: a host sync,
                                        and the branch taken at capture is
                                        the only one ever replayed
TPU104   captured-config-arg            a captured program taking a config-like
                                        argument: the graph bakes in its
                                        capture-time value and a replay
                                        ignores a new one (the JAX rule's
                                        ``static_argnames``: here the value
                                        belongs in the factory's closure, one
                                        capture per value)
TPU201   broad-except                   ``except Exception:`` that does not
                                        re-raise: swallows device errors
TPU202   mutable-default-arg            list/dict/set defaults: shared state
                                        across calls
TPU203   unrouted-hot-path-program      a program or kernel site (a CUDA
                                        graph, ``torch.compile``, a ``jit``, a
                                        kernel library load) under serve/ or
                                        parallel/ outside ``ops/cuda_build.py``
                                        and ``serve/graphs.py`` and outside the
                                        factories they route
                                        (``TPULINT_ROUTED_FACTORIES``): it
                                        escapes the kernel cache, the launch
                                        counters and the graph pool
TPU405   swallowed-exception-in-        a broad ``except`` under serve/ or
         serving-path                   lifecycle/ whose handler neither
                                        re-raises, returns a wire-shaped
                                        error, routes the error to a waiter,
                                        logs at error level, nor increments
                                        a metric
======== ============================== =======================================

``TPU105`` (train-step-missing-donate) has no meaning here:
``donate_argnums`` lets XLA reuse a jitted step's input buffers for its
outputs, and eager PyTorch has no such double buffering to avoid, since
the port's optimizers update parameters and their state in place
(``UNMAPPED_RULES``).

``TPULINT_CAPTURED`` entries read ``"ops/predict.py::make_packed_predict_base"``
(a factory in the file whose path ends so) or a bare factory name (a
factory of the declaring file itself). The manifests of the package's
``serve/graphs.py`` always apply; a file analyzed alone may declare its
own. Suppress any finding inline with ``# tpulint: disable=TPU101`` on
(or directly above) the flagged line.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import re
from pathlib import Path
from typing import Iterable

from mlops_tpu_torch.analysis.findings import (
    Finding,
    Severity,
    file_skipped,
    is_suppressed,
)
from mlops_tpu_torch.analysis.seriesreg import module_literals

CAPTURED_NAME = "TPULINT_CAPTURED"
ROUTED_NAME = "TPULINT_ROUTED_FACTORIES"
# Where the package declares both manifests.
_MANIFEST_HOME = Path(__file__).resolve().parents[1] / "serve" / "graphs.py"
# The modules that build, load and capture the hot programs: their own
# sites are the routing.
_ROUTING_MODULES = ("ops/cuda_build.py", "serve/graphs.py")

# Path segments whose program sites TPU203 polices: the serving and
# parallel trees are the per-process hot programs.
_HOT_PATH_SEGMENTS = {"serve", "parallel"}

# Path segments whose broad excepts TPU405 polices: the serving and
# lifecycle trees, where a swallowed failure means a request or a
# control-loop transition silently vanishes.
_SERVING_PATH_SEGMENTS = {"serve", "lifecycle"}
# Attribute-call names TPU405 accepts as "the failure was recorded": the
# logging error-level surface plus future/waiter error routing.
_EXC_ACTION_ATTRS = {"exception", "error", "critical", "set_exception"}


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    rule: str
    name: str
    severity: Severity
    summary: str


RULES: dict[str, RuleInfo] = {
    r.rule: r
    for r in (
        RuleInfo("TPU101", "host-sync-under-capture", Severity.ERROR,
                 "host synchronization inside a captured program"),
        RuleInfo("TPU102", "host-rng-or-clock-under-capture", Severity.ERROR,
                 "Python RNG/clock call inside a captured program"),
        RuleInfo("TPU103", "tensor-branch", Severity.ERROR,
                 "data-dependent Python branch on a tensor"),
        RuleInfo("TPU104", "captured-config-arg", Severity.ERROR,
                 "captured program taking a config-like argument"),
        RuleInfo("TPU201", "broad-except", Severity.ERROR,
                 "broad except swallowing device errors"),
        RuleInfo("TPU202", "mutable-default-arg", Severity.ERROR,
                 "mutable default argument"),
        RuleInfo("TPU203", "unrouted-hot-path-program", Severity.ERROR,
                 "hot-path program or kernel not routed through "
                 "ops/cuda_build.py / serve/graphs.py"),
        RuleInfo("TPU405", "swallowed-exception-in-serving-path", Severity.ERROR,
                 "serving-path broad except that records nothing"),
    )
}

# The JAX package's rule ids that have no PyTorch meaning, and why.
UNMAPPED_RULES: dict[str, str] = {
    "TPU105": (
        "train-step-missing-donate: donate_argnums lets XLA alias a jitted "
        "step's inputs to its outputs; eager PyTorch keeps no second copy "
        "to avoid, the port's optimizers updating params and state in place"
    ),
    "TPU302": (
        "weak-type-output: JAX's weakly typed Python scalars have no "
        "PyTorch counterpart; a torch tensor's dtype is always concrete"
    ),
}

# Attribute reads on a tensor that stay static under capture (metadata).
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "numel", "dim", "layout"}
# Host-sync method calls on any value inside a captured program.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# Host-sync/materialization calls by dotted name inside a captured program.
_SYNC_CALLS = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "torch.cuda.synchronize",
}
# Ops whose output shape depends on the data: a sync unless given a size.
_DATA_SHAPED = {"nonzero", "argwhere"}
_RNG_CLOCK_ROOTS = ("random.", "np.random.", "numpy.random.")
_CLOCK_CALLS = {
    "time.time",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.process_time",
    "time.sleep",
    "datetime.now",
    "datetime.datetime.now",
    "datetime.utcnow",
    "datetime.datetime.utcnow",
}
_CONFIG_ARG_NAMES = {"config", "cfg", "conf", "options", "opts", "settings"}
# Program and kernel sites (TPU203), by the last components of the
# callee's dotted name.
_PROGRAM_LEAVES = {"jit", "pjit", "CUDAGraph", "make_graphed_callables",
                   "CDLL", "LoadLibrary", "load_inline"}
_PROGRAM_SUFFIXES = ("torch.compile", "cuda.graph", "cpp_extension.load")


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _fn_args(node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda):
    a = node.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


def _is_config_like(arg: ast.arg) -> bool:
    ann = ast.unparse(arg.annotation) if arg.annotation is not None else ""
    return arg.arg.lower() in _CONFIG_ARG_NAMES or "Config" in ann


def _is_program_site(name: str) -> bool:
    leaf = name.split(".")[-1]
    return leaf in _PROGRAM_LEAVES or any(
        name == s or name.endswith("." + s) for s in _PROGRAM_SUFFIXES
    )


_FnDef = ast.FunctionDef | ast.AsyncFunctionDef


def _scope_nodes(body: list[ast.stmt]) -> Iterable[ast.AST]:
    """Every node lexically in this scope: descends into statements and
    expressions but NOT into nested function/lambda bodies (those are new
    scopes). Function nodes themselves are yielded (their decorators and
    default expressions evaluate in THIS scope)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(d for d in node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
        elif isinstance(node, ast.Lambda):
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
        else:
            stack.extend(ast.iter_child_nodes(node))


@functools.lru_cache(maxsize=1)
def package_manifests() -> tuple[tuple[str, ...], frozenset[str]]:
    """The package's ``TPULINT_CAPTURED`` entries and routed factory
    names, read from ``serve/graphs.py``'s source."""
    manifests = module_literals(ast.parse(_MANIFEST_HOME.read_text(encoding="utf-8")),
                                {CAPTURED_NAME, ROUTED_NAME})
    captured = tuple(manifests.get(CAPTURED_NAME, ()))
    routed = frozenset(manifests.get(ROUTED_NAME, ()))
    return captured, routed


def _ends_with(rel_path: str, suffix: str) -> bool:
    return rel_path == suffix or rel_path.endswith("/" + suffix)


def _captured_factories(tree: ast.Module, rel_path: str) -> set[str]:
    """Factory names whose programs this file's captures record."""
    entries = list(package_manifests()[0])
    own = module_literals(tree, {CAPTURED_NAME}).get(CAPTURED_NAME, ())
    names: set[str] = set()
    for entry in entries:
        path, _, name = entry.partition("::")
        if name and _ends_with(rel_path, path):
            names.add(name)
    for entry in own:
        path, sep, name = entry.partition("::")
        if not sep:
            names.add(path)
        elif _ends_with(rel_path, path):
            names.add(name)
    return names


class _TraceCollector:
    """Module pre-pass: which def/lambda nodes run inside a captured
    program (everything nested in a declared factory), which defs are the
    captured programs themselves (TPU104), and the program sites with
    their enclosing def names (TPU203)."""

    def __init__(self, factories: set[str]) -> None:
        self.factories = factories
        self.traced_fns: set[int] = set()
        self.traced_lambdas: set[int] = set()
        self.programs: list[_FnDef] = []
        self.sites: list[tuple[ast.AST, str, tuple[str, ...]]] = []

    def collect(self, tree: ast.Module) -> None:
        self._scope(tree.body, (), False)

    def _scope(self, body: list[ast.stmt], names: tuple[str, ...],
               in_factory: bool) -> None:
        nested: list[_FnDef] = []
        for node in _scope_nodes(body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.append(node)
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    name = _dotted(target) or ""
                    if _is_program_site(name):
                        self.sites.append((node, name, names))
            elif isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if _is_program_site(name):
                    self.sites.append((node, name, names))
            elif isinstance(node, ast.Lambda) and in_factory:
                self.traced_lambdas.add(id(node))
        for fn in nested:
            if in_factory:
                self.traced_fns.add(id(fn))
            elif fn.name in self.factories:
                self.programs.extend(
                    n for n in _scope_nodes(fn.body)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                )
            self._scope(fn.body, (*names, fn.name),
                        in_factory or fn.name in self.factories)


class _RuleVisitor(ast.NodeVisitor):
    def __init__(self, path: str, collector: _TraceCollector,
                 rel_path: str | None = None) -> None:
        self.path = path
        # Path RELATIVE to the analyzed root, used for scope decisions
        # (TPU203, TPU405): directory names above the root never count.
        self.rel_path = rel_path if rel_path is not None else path
        self.c = collector
        self.findings: list[Finding] = []
        self._traced_depth = 0  # >0 while inside a captured program
        self._tracer_names: list[set[str]] = []  # param names per program

    # ------------------------------------------------------------- helpers
    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        info = RULES[rule]
        self.findings.append(
            Finding(
                rule=info.rule,
                name=info.name,
                severity=info.severity,
                path=self.path,
                line=getattr(node, "lineno", 0),
                message=message,
            )
        )

    @property
    def _in_trace(self) -> bool:
        return self._traced_depth > 0

    def _tracers(self) -> set[str]:
        out: set[str] = set()
        for names in self._tracer_names:
            out |= names
        return out

    def _segments(self) -> set[str]:
        return set(re.split(r"[\\/]+", self.rel_path))

    # ------------------------------------------------------ scope tracking
    def _enter_fn(self, node: _FnDef | ast.Lambda) -> None:
        traced = (
            id(node) in self.c.traced_fns
            or id(node) in self.c.traced_lambdas
            or self._in_trace
        )
        if traced:
            self._traced_depth += 1
            self._tracer_names.append({a.arg for a in _fn_args(node)})
        else:
            self._tracer_names.append(set())
        if not isinstance(node, ast.Lambda):
            self._check_mutable_defaults(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self._tracer_names.pop()
        if traced:
            self._traced_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_fn(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_fn(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._enter_fn(node)

    # ------------------------------------------------------------- TPU202
    def _check_mutable_defaults(self, node: _FnDef) -> None:
        defaults = [*node.args.defaults, *node.args.kw_defaults]
        for default in defaults:
            if default is None:
                continue
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set))
            if isinstance(default, ast.Call):
                callee = _dotted(default.func) or ""
                mutable = callee in {"list", "dict", "set", "bytearray"}
            if mutable:
                self._flag(
                    "TPU202",
                    default,
                    f"mutable default argument in {node.name}() is shared "
                    "across calls; default to None and construct inside",
                )

    # ------------------------------------------------------ TPU201/TPU405
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad_names = ("Exception", "BaseException")

        def is_broad_name(t: ast.AST) -> bool:
            return isinstance(t, ast.Name) and t.id in broad_names

        broad = (
            node.type is None
            or is_broad_name(node.type)
            or (
                isinstance(node.type, ast.Tuple)
                and any(is_broad_name(e) for e in node.type.elts)
            )
        )
        # A re-raise anywhere in the handler means nothing is swallowed;
        # nested defs are their own scope and don't count.
        reraises = any(
            isinstance(sub, ast.Raise)
            for stmt in node.body
            for sub in _scope_nodes([stmt])
        )
        if broad and not reraises:
            caught = "bare except" if node.type is None else (
                f"except {ast.unparse(node.type)}"
            )
            self._flag(
                "TPU201",
                node,
                f"{caught} without re-raise swallows device errors "
                "(CUDA errors, NumericCheckError) — catch the specific "
                "exceptions or justify with a disable comment",
            )
        # TPU405: on serving paths even a JUSTIFIED broad except must
        # visibly ACT on the failure (orthogonal to TPU201 by design).
        if (
            broad
            and _SERVING_PATH_SEGMENTS & self._segments()
            and not reraises
            and not self._handler_acts(node)
        ):
            self._flag(
                "TPU405",
                node,
                "broad except on a serving path swallows the failure "
                "without a trace — re-raise, return a wire-shaped error, "
                "route it to a waiter (set_exception), log it via "
                "logger.exception/error, or increment a named metric",
            )
        self.generic_visit(node)

    @staticmethod
    def _handler_acts(node: ast.ExceptHandler) -> bool:
        """Does the handler body (nested defs excluded) visibly act on the
        failure: a ``return``, an error-level log / waiter-routing call,
        or an augmented assignment (a counter increment)?"""
        for stmt in node.body:
            for sub in _scope_nodes([stmt]):
                if isinstance(sub, (ast.Return, ast.AugAssign)):
                    return True
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _EXC_ACTION_ATTRS
                ):
                    return True
        return False

    # ------------------------------------------------------ TPU101/TPU102
    def visit_Call(self, node: ast.Call) -> None:
        if self._in_trace:
            self._check_host_sync(node)
            self._check_rng_clock(node)
        self.generic_visit(node)

    def _check_host_sync(self, node: ast.Call) -> None:
        name = _dotted(node.func) or ""
        leaf = name.split(".")[-1] if name else (
            node.func.attr if isinstance(node.func, ast.Attribute) else ""
        )
        sized = any(k.arg == "size" for k in node.keywords)
        if name in _SYNC_CALLS:
            self._flag(
                "TPU101",
                node,
                f"{name}() inside a captured program synchronizes with the "
                "host — a capture cannot record it; keep the work on the "
                "device",
            )
        elif isinstance(node.func, ast.Attribute) and leaf in _SYNC_METHODS:
            self._flag(
                "TPU101",
                node,
                f".{leaf}() inside a captured program forces a device->host "
                "sync — a capture cannot record it",
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and leaf == "to"
            and any(isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in node.args)
        ):
            self._flag(
                "TPU101",
                node,
                ".to('cpu') inside a captured program forces a device->host "
                "copy and sync",
            )
        elif (leaf in _DATA_SHAPED or (leaf == "where" and len(node.args) == 1)) and not sized:
            self._flag(
                "TPU101",
                node,
                f"{leaf}() without a size inside a captured program: its "
                "output shape depends on the data, so the host must wait "
                "for it — use a masked form or a static size",
            )
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and len(node.args) == 1
            and self._mentions_tracer(node.args[0])
        ):
            self._flag(
                "TPU101",
                node,
                f"{node.func.id}() on a tensor inside a captured program "
                "reads it on the host (a sync) and freezes the value into "
                "the graph — keep it a tensor",
            )

    def _check_rng_clock(self, node: ast.Call) -> None:
        name = _dotted(node.func) or ""
        if name.startswith(_RNG_CLOCK_ROOTS) or name in _CLOCK_CALLS:
            self._flag(
                "TPU102",
                node,
                f"{name}() in a captured program runs ONCE, at capture, and "
                "every replay reuses its value — draw from a torch.Generator "
                "on the device, or pass host values in as tensors",
            )

    # ------------------------------------------------------------- TPU103
    def _mentions_tracer(self, test: ast.AST) -> bool:
        """Does ``test`` read a probable tensor (a captured program's
        parameter) in a data-dependent way (not just its metadata)?"""
        tracers = self._tracers()
        if not tracers:
            return False
        static_values: set[int] = set()
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                for inner in ast.walk(sub.value):
                    static_values.add(id(inner))
            if isinstance(sub, ast.Call):
                callee = _dotted(sub.func) or ""
                if callee in ("len", "isinstance", "type", "hasattr"):
                    for arg in sub.args:
                        for inner in ast.walk(arg):
                            static_values.add(id(inner))
            if isinstance(sub, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops
            ):
                for inner in ast.walk(sub):
                    static_values.add(id(inner))
        for sub in ast.walk(test):
            if (
                isinstance(sub, ast.Name)
                and isinstance(sub.ctx, ast.Load)
                and sub.id in tracers
                and id(sub) not in static_values
            ):
                return True
        return False

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")
        self.generic_visit(node)

    def _check_branch(self, node: ast.If | ast.While, kind: str) -> None:
        if self._in_trace and self._mentions_tracer(node.test):
            self._flag(
                "TPU103",
                node,
                f"Python `{kind}` on a tensor in a captured program — the "
                "host syncs to decide, and the branch taken at capture is "
                "the only one replayed; use torch.where or masked "
                "arithmetic",
            )

    # ------------------------------------------------------ TPU104/TPU203
    def check_programs(self, routed: frozenset[str]) -> None:
        for fn in self.c.programs:
            for arg in _fn_args(fn):
                if _is_config_like(arg):
                    self._flag(
                        "TPU104",
                        fn,
                        f"captured program {fn.name}() takes config-like "
                        f"argument {arg.arg!r} — the graph bakes in its "
                        "capture-time value and replays ignore a new one; "
                        "bind it in the factory (one capture per value)",
                    )
                    break
        hot = bool(_HOT_PATH_SEGMENTS & self._segments())
        routing = any(_ends_with(self.rel_path, m) for m in _ROUTING_MODULES)
        if not hot or routing:
            return
        for site, name, enclosing in self.c.sites:
            if set(enclosing) & routed:
                continue
            self._flag(
                "TPU203",
                site,
                f"{name} on a serving/parallel hot path outside "
                "ops/cuda_build.py, serve/graphs.py and the factories they "
                f"route ({', '.join(sorted(routed))}) — the program escapes "
                "the kernel cache, the launch counters and the graph pool; "
                "route it or justify with a disable comment",
            )


def analyze_source(
    source: str,
    path: str | Path,
    rel_path: str | Path | None = None,
    keep_suppressed: bool = False,
) -> list[Finding]:
    """Run every Layer-1 rule over one file's source text. ``rel_path``
    (the path relative to the analyzed root) scopes the path-predicated
    rules and the manifest's entries; it defaults to ``path``.
    ``keep_suppressed`` returns findings that inline disables would hide
    (the suppression auditor tells live disables from stale with it)."""
    path = str(path)
    if file_skipped(source):
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as err:
        return [
            Finding(
                rule="TPU000",
                name="syntax-error",
                severity=Severity.ERROR,
                path=path,
                line=err.lineno or 0,
                message=f"file does not parse: {err.msg}",
            )
        ]
    rel = Path(rel_path if rel_path else path).as_posix()
    collector = _TraceCollector(_captured_factories(tree, rel))
    collector.collect(tree)
    routed = package_manifests()[1] | frozenset(
        module_literals(tree, {ROUTED_NAME}).get(ROUTED_NAME, ()))
    visitor = _RuleVisitor(path, collector, rel_path=rel)
    visitor.visit(tree)
    visitor.check_programs(routed)
    if keep_suppressed:
        return visitor.findings
    lines = source.splitlines()
    return [f for f in visitor.findings if not is_suppressed(f, lines)]


def iter_py_files(
    paths: Iterable[str | Path],
) -> Iterable[tuple[Path, Path]]:
    """(file, rel) for every ``.py`` under ``paths`` — the one directory
    walk shared by all analyzer layers and the suppression auditor. ``rel``
    is the path under the analyzed root, so directory names ABOVE the root
    never trip path-scoped rules; the root's own name still counts."""
    for path in paths:
        path = Path(path)
        if path.is_dir():
            files = [(f, Path(path.name) / f.relative_to(path))
                     for f in sorted(path.rglob("*.py"))]
        else:
            files = [(path, path)]
        for file, rel in files:
            if "__pycache__" in file.parts:
                continue
            yield file, rel


def analyze_paths(paths: Iterable[str | Path]) -> list[Finding]:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    findings: list[Finding] = []
    for file, rel in iter_py_files(paths):
        findings.extend(
            analyze_source(
                file.read_text(encoding="utf-8"),
                file.as_posix(),
                rel_path=rel.as_posix(),
            )
        )
    return findings
