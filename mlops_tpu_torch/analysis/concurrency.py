"""Layer 3: concurrency analysis over the hand-rolled threading layer.

The package runs a real threaded serving and streaming stack — the
pipeline executor's stage threads (`data/pipeline_exec.py`), the
micro-batcher's dispatch/fetch rings (`serve/batcher.py`), the engine's
device and totals locks (`serve/engine.py`), the ring service's bound —
whose defects are of a few known kinds (a blocking device call stalling
every request under a lock; a dispatch slot released before the fetch
ring was claimed; a stale cumulative snapshot racing a newer one). These
invariants are machine-checked here. Pure ``ast`` — like Layer 1, this
module must never import torch.

======== ============================== =======================================
ID       name                           catches
======== ============================== =======================================
TPU401   lock-order-violation           nested lock acquisition that inverts
                                        the declared order manifest
                                        (``TPULINT_LOCK_ORDER``), closes a
                                        cycle, or involves an undeclared lock
TPU402   unguarded-shared-write         an attribute written both under and
                                        outside its dominant lock — the
                                        inferred guard is not actually held on
                                        every write path
TPU403   blocking-under-lock            a blocking call (device fetch /
                                        ``block_until_ready`` / ``np.asarray``
                                        / a ``.compile()`` / ``queue.put`` /
                                        ``join`` / file I/O / ``time.sleep``)
                                        while a mutex is held: every
                                        request queued on it stalls
TPU404   semaphore-pairing              a semaphore acquired with no release
                                        anywhere in its class, or acquired in
                                        a function that never releases it
                                        without a declared cross-method
                                        pairing (``TPULINT_CROSS_METHOD_
                                        SEMAPHORES``)
======== ============================== =======================================

Declarations are read from the analyzed source itself (plain literals, so
the manifest lives next to the locks it orders):

    TPULINT_LOCK_ORDER = {"InferenceEngine": ("_compile_lock", "_acc_lock")}
    TPULINT_CROSS_METHOD_SEMAPHORES = {"MicroBatcher": ("_inflight",)}

``TPULINT_LOCK_ORDER`` maps a class name (or ``"<module>"`` for
module-level locks) to its lock attributes OUTERMOST FIRST: holding a
later lock while acquiring an earlier one is an inversion. The same
declaration is the runtime sanitizer's order source
(`analysis/lockcheck.py`), so the static and dynamic checks can never
disagree about the intended order.

Semantics are lexical and deliberately conservative: ``with self.<lock>``
blocks and bare ``.acquire()``/``.release()`` statements toggle a
held-lock set walked in statement order; nested function bodies start a
fresh (empty) held context because they execute later. Suppress a finding
the usual way (``# tpulint: disable=TPU403`` + justification).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable

from mlops_tpu_torch.analysis import blocking
from mlops_tpu_torch.analysis.findings import (
    Finding,
    Severity,
    file_skipped,
    is_suppressed,
)

MODULE_SCOPE = "<module>"

# Source-level declaration names (parsed as literals, never imported).
LOCK_ORDER_NAME = "TPULINT_LOCK_ORDER"
CROSS_METHOD_NAME = "TPULINT_CROSS_METHOD_SEMAPHORES"

# Constructor leaf names -> primitive kind. Matched on the last dotted
# component so ``threading.Lock``, ``asyncio.Lock`` and a bare ``Lock``
# all hit. Semaphores bound concurrency rather than guard state, so they
# participate in ordering (TPU401) and pairing (TPU404) but are never a
# "guard" for TPU402 and never make a region "under a mutex" for TPU403.
_MUTEX_FACTORIES = {"Lock", "RLock", "Condition"}
_SEMAPHORE_FACTORIES = {"Semaphore", "BoundedSemaphore"}


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    rule: str
    name: str
    severity: Severity
    summary: str


CONCURRENCY_RULES: dict[str, RuleInfo] = {
    r.rule: r
    for r in (
        RuleInfo(
            "TPU401",
            "lock-order-violation",
            Severity.ERROR,
            "nested lock acquisition violates the declared order",
        ),
        RuleInfo(
            "TPU402",
            "unguarded-shared-write",
            Severity.ERROR,
            "attribute written outside its dominant lock",
        ),
        RuleInfo(
            "TPU403",
            "blocking-under-lock",
            Severity.ERROR,
            "blocking call while a mutex is held",
        ),
        RuleInfo(
            "TPU404",
            "semaphore-pairing",
            Severity.ERROR,
            "semaphore acquire without a matching release path",
        ),
    )
}

# ---------------------------------------------------------- blocking model
# The blocking-call table is SHARED with Layer 5 (asyncdiscipline.py):
# one classifier decides "does this call block?" for both the held-mutex
# walk (TPU403) and the event-loop-confinement walk (TPU601), so the two
# layers can never disagree about what a stall is. The table lives in
# blocking.py; the historical module-private names stay importable here.
_BLOCKING_METHODS = blocking.BLOCKING_METHODS
_BLOCKING_CALLS = blocking.BLOCKING_CALLS
_JOIN_SAFE_ROOTS = blocking.JOIN_SAFE_ROOTS
_COMPILE_SAFE_ROOTS = blocking.COMPILE_SAFE_ROOTS
_dotted = blocking.dotted


@dataclasses.dataclass
class _Scope:
    """One lock namespace: a class, or the module itself."""

    name: str
    mutexes: set[str] = dataclasses.field(default_factory=set)
    semaphores: set[str] = dataclasses.field(default_factory=set)
    # TPU401: (held-lock, acquired-lock) -> first acquisition site node.
    edges: dict[tuple[str, str], ast.AST] = dataclasses.field(
        default_factory=dict
    )
    # TPU402: attr -> list of (held-mutexes frozenset, node, method, in_init)
    writes: dict[str, list] = dataclasses.field(default_factory=dict)
    # TPU404 bookkeeping.
    sem_acquires: dict[str, list[ast.AST]] = dataclasses.field(
        default_factory=dict
    )
    sem_releases: dict[str, int] = dataclasses.field(default_factory=dict)
    # function name -> {sem: [acquire nodes]} / {sem: release count}
    fn_acquires: dict[str, dict[str, list[ast.AST]]] = dataclasses.field(
        default_factory=dict
    )
    fn_releases: dict[str, set[str]] = dataclasses.field(default_factory=dict)

    @property
    def locks(self) -> set[str]:
        return self.mutexes | self.semaphores


class _Collector:
    """One pass over a module: lock discovery, declarations, then a
    held-set walk of every function/method body."""

    def __init__(self, tree: ast.Module) -> None:
        self.tree = tree
        self.order: dict[str, tuple[str, ...]] = {}
        self.cross_method: dict[str, set[str]] = {}
        self.module_scope = _Scope(MODULE_SCOPE)
        self.class_scopes: dict[str, _Scope] = {}
        self.findings: list[Finding] = []
        self._path = ""

    # ----------------------------------------------------------- discovery
    def collect(self, path: str) -> list[Finding]:
        self._path = path
        self._read_declarations()
        self._discover_locks()
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(self.module_scope, node)
            elif isinstance(node, ast.ClassDef):
                scope = self.class_scopes.get(node.name)
                if scope is None:
                    # Lock-less class: its methods can still nest/hold
                    # MODULE-level locks, so they get an ephemeral scope
                    # (checked like any other) rather than being skipped.
                    scope = self.class_scopes[node.name] = _Scope(node.name)
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._walk_function(scope, item)
        for scope in (self.module_scope, *self.class_scopes.values()):
            self._check_order(scope)
            self._check_guards(scope)
            self._check_semaphores(scope)
        return self.findings

    def _read_declarations(self) -> None:
        for node in self.tree.body:
            # Both `X = {...}` and the annotated `X: dict = {...}` count —
            # dropping an annotated manifest would silently turn TPU401
            # into cycles-only mode while the runtime half still saw it.
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value_node = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value_node = node.target, node.value
            else:
                continue
            if not isinstance(target, ast.Name):
                continue
            if target.id not in (LOCK_ORDER_NAME, CROSS_METHOD_NAME):
                continue
            try:
                value = ast.literal_eval(value_node)
            except (ValueError, SyntaxError):
                continue  # non-literal manifest: ignore rather than crash
            if not isinstance(value, dict):
                continue
            for key, names in value.items():
                if target.id == LOCK_ORDER_NAME:
                    self.order[str(key)] = tuple(names)
                else:
                    self.cross_method.setdefault(str(key), set()).update(
                        names
                    )

    @staticmethod
    def _factory_kind(value: ast.AST) -> str | None:
        if not isinstance(value, ast.Call):
            return None
        leaf = (_dotted(value.func) or "").split(".")[-1]
        if leaf in _MUTEX_FACTORIES:
            return "mutex"
        if leaf in _SEMAPHORE_FACTORIES:
            return "semaphore"
        return None

    def _discover_locks(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                kind = self._factory_kind(node.value)
                if kind:
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            bucket = (
                                self.module_scope.mutexes
                                if kind == "mutex"
                                else self.module_scope.semaphores
                            )
                            bucket.add(target.id)
            elif isinstance(node, ast.ClassDef):
                scope = _Scope(node.name)
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    kind = self._factory_kind(sub.value)
                    if not kind:
                        continue
                    for target in sub.targets:
                        if (
                            isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                        ):
                            bucket = (
                                scope.mutexes
                                if kind == "mutex"
                                else scope.semaphores
                            )
                            bucket.add(target.attr)
                if scope.locks:
                    self.class_scopes[node.name] = scope

    # ------------------------------------------------------------ the walk
    def _lock_name(self, scope: _Scope, expr: ast.AST) -> str | None:
        """``self.<lock>`` (class scope) or bare ``<lock>`` (module lock)."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in scope.locks
        ):
            return expr.attr
        if isinstance(expr, ast.Name) and expr.id in self.module_scope.locks:
            return expr.id
        return None

    def _kind_of(self, scope: _Scope, name: str) -> str:
        if name in scope.mutexes or name in self.module_scope.mutexes:
            return "mutex"
        return "semaphore"

    def _acquire_call(self, scope: _Scope, expr: ast.AST) -> str | None:
        """The lock name when ``expr`` is ``<lock>.acquire(...)`` (possibly
        awaited)."""
        if isinstance(expr, ast.Await):
            expr = expr.value
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "acquire"
        ):
            return self._lock_name(scope, expr.func.value)
        return None

    def _release_call(self, scope: _Scope, expr: ast.AST) -> str | None:
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "release"
        ):
            return self._lock_name(scope, expr.func.value)
        return None

    def _walk_function(
        self, scope: _Scope, fn: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> None:
        fn_acq: dict[str, list[ast.AST]] = {}
        fn_rel: set[str] = set()
        in_init = fn.name == "__init__"

        def note_edges(name: str, site: ast.AST, held: list[str]) -> None:
            for h in held:
                scope.edges.setdefault((h, name), site)

        def scan_expr(node: ast.AST, held: list[str]) -> None:
            """Blocking calls (TPU403) + attribute writes (TPU402) inside
            ONE simple statement / header expression. Never descends into
            nested statements (the walk visits those with the right held
            set) nor nested defs/lambdas (fresh execution context)."""
            held_mutexes = frozenset(
                h for h in held if self._kind_of(scope, h) == "mutex"
            )
            stack = [node]
            while stack:
                sub = stack.pop()
                if isinstance(
                    sub,
                    (ast.stmt, ast.Lambda),
                ) and sub is not node:
                    continue  # nested statement or deferred lambda body
                if held_mutexes and isinstance(sub, ast.Call):
                    self._check_blocking(sub, held_mutexes)
                if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        sub.targets
                        if isinstance(sub, ast.Assign)
                        else [sub.target]
                    )
                    for target in targets:
                        attr = self._written_attr(target)
                        if attr is not None and attr not in scope.locks:
                            scope.writes.setdefault(attr, []).append(
                                (held_mutexes, sub, fn.name, in_init)
                            )
                stack.extend(ast.iter_child_nodes(sub))

        def walk(stmts: list[ast.stmt], held: list[str]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    acquired: list[str] = []
                    for item in stmt.items:
                        name = self._lock_name(scope, item.context_expr)
                        if name is not None:
                            # `with <sem>:` is lexically balanced — TPU404
                            # only tracks bare acquire()/release() splits
                            note_edges(name, stmt, held + acquired)
                            acquired.append(name)
                        else:
                            # held + acquired: in `with self._lock, open(p):`
                            # the open() runs with the lock already held
                            scan_expr(item.context_expr, held + acquired)
                    walk(stmt.body, held + acquired)
                    continue
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # nested def: fresh held context at call time
                    self._walk_function(scope, stmt)
                    continue
                # bare acquire()/release() as a statement (or assigned)
                value = getattr(stmt, "value", None)
                toggled = False
                if isinstance(stmt, (ast.Expr, ast.Assign)) and value is not None:
                    name = self._acquire_call(scope, value)
                    if name is not None:
                        note_edges(name, stmt, held)
                        if name in scope.semaphores:
                            scope.sem_acquires.setdefault(name, []).append(
                                stmt
                            )
                            fn_acq.setdefault(name, []).append(stmt)
                        held.append(name)
                        toggled = True
                    else:
                        name = self._release_call(scope, value)
                        if name is not None:
                            if name in held:
                                held.remove(name)
                            if name in scope.semaphores:
                                scope.sem_releases[name] = (
                                    scope.sem_releases.get(name, 0) + 1
                                )
                                fn_rel.add(name)
                            toggled = True
                if not toggled:
                    # header expressions of compound statements (if/while
                    # tests, for iterables) and whole simple statements —
                    # their bodies are walked below with the live held set
                    if isinstance(stmt, (ast.If, ast.While)):
                        scan_expr(stmt.test, held)
                    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                        scan_expr(stmt.iter, held)
                    elif isinstance(stmt, ast.Try):
                        pass  # nothing but nested statements
                    else:
                        scan_expr(stmt, held)
                for body_attr in ("body", "orelse", "finalbody"):
                    body = getattr(stmt, body_attr, None)
                    if isinstance(body, list):
                        walk(body, held)
                for handler in getattr(stmt, "handlers", []) or []:
                    walk(handler.body, held)

        walk(fn.body, [])
        scope.fn_acquires[fn.name] = fn_acq
        scope.fn_releases[fn.name] = fn_rel

    @staticmethod
    def _written_attr(target: ast.AST) -> str | None:
        """``self.X = / self.X[...] =`` -> ``X`` (tuple targets handled by
        the caller iterating; nested tuples recursed here)."""
        if isinstance(target, ast.Subscript):
            target = target.value
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            return target.attr
        return None

    # ------------------------------------------------------------- TPU403
    def _check_blocking(
        self, call: ast.Call, held_mutexes: frozenset[str]
    ) -> None:
        held = ", ".join(sorted(held_mutexes))
        label = blocking.classify_blocking(call)
        if label is None:
            return
        if label == ".get() (blocking queue read)":
            self._flag(
                "TPU403",
                call,
                f"{label} while holding {held}",
            )
        elif label.startswith("."):
            self._flag(
                "TPU403",
                call,
                f"{label} while holding {held} blocks every thread "
                "queued on the lock — move the blocking work outside the "
                "critical section",
            )
        else:
            self._flag(
                "TPU403",
                call,
                f"{label} while holding {held} blocks every thread queued "
                "on the lock (device fetch / host materialization / I/O "
                "belongs outside the critical section)",
            )

    # ------------------------------------------------------------- TPU401
    def _check_order(self, scope: _Scope) -> None:
        order = self.order.get(scope.name)
        if order is not None:
            rank = {name: i for i, name in enumerate(order)}
            for (held, acquired), site in scope.edges.items():
                if held not in rank or acquired not in rank:
                    missing = acquired if acquired not in rank else held
                    self._flag(
                        "TPU401",
                        site,
                        f"nested acquisition of {acquired!r} while holding "
                        f"{held!r}, but {missing!r} is not in "
                        f"{LOCK_ORDER_NAME}[{scope.name!r}] — declare every "
                        "lock that participates in nesting",
                    )
                elif rank[acquired] < rank[held]:
                    self._flag(
                        "TPU401",
                        site,
                        f"acquiring {acquired!r} while holding {held!r} "
                        f"inverts the declared order {order} — a thread "
                        "taking them in the declared order deadlocks "
                        "against this one",
                    )
            return
        # No declared order: only flag actual cycles (pairs of edges that
        # can deadlock against each other).
        adjacency: dict[str, set[str]] = {}
        for held, acquired in scope.edges:
            adjacency.setdefault(held, set()).add(acquired)

        def reachable(src: str, dst: str) -> bool:
            seen, stack = set(), [src]
            while stack:
                node = stack.pop()
                if node == dst:
                    return True
                if node in seen:
                    continue
                seen.add(node)
                stack.extend(adjacency.get(node, ()))
            return False

        for (held, acquired), site in scope.edges.items():
            if reachable(acquired, held):
                self._flag(
                    "TPU401",
                    site,
                    f"acquiring {acquired!r} while holding {held!r} closes "
                    "a lock-order cycle (the opposite nesting exists "
                    "elsewhere in this scope) — two threads taking the two "
                    f"paths deadlock; declare {LOCK_ORDER_NAME} and fix "
                    "the inverted site",
                )

    # ------------------------------------------------------------- TPU402
    def _check_guards(self, scope: _Scope) -> None:
        if scope.name == MODULE_SCOPE:
            return  # module globals: too little structure to infer guards
        for attr, writes in scope.writes.items():
            guarded = [w for w in writes if w[0] and not w[3]]
            if not guarded:
                continue
            counts: dict[str, int] = {}
            for held, *_ in guarded:
                for lock in held:
                    counts[lock] = counts.get(lock, 0) + 1
            dominant = max(sorted(counts), key=lambda k: counts[k])
            for held, node, method, in_init in writes:
                if in_init:
                    continue  # construction precedes sharing
                if dominant not in held:
                    self._flag(
                        "TPU402",
                        node,
                        f"self.{attr} is written under {dominant!r} in "
                        f"{len(guarded)} place(s) but written here "
                        f"({method}) without it — either every write "
                        "holds the inferred guard or none should",
                    )

    # ------------------------------------------------------------- TPU404
    def _check_semaphores(self, scope: _Scope) -> None:
        dangling: set[str] = set()
        for sem, acquires in scope.sem_acquires.items():
            if not scope.sem_releases.get(sem):
                dangling.add(sem)
                self._flag(
                    "TPU404",
                    acquires[0],
                    f"{sem!r} is acquired here but never released anywhere "
                    f"in {scope.name} — every permit taken is gone for "
                    "good and the ring wedges at capacity",
                )
        declared = self.cross_method.get(scope.name, set())
        for fn_name, acq in scope.fn_acquires.items():
            released = scope.fn_releases.get(fn_name, set())
            for sem, sites in acq.items():
                if sem in dangling or sem in declared or sem in released:
                    continue
                self._flag(
                    "TPU404",
                    sites[0],
                    f"{fn_name}() acquires {sem!r} but never releases it "
                    "on any of its own paths — if the release legitimately "
                    "lives in another method (two-phase dispatch/fetch), "
                    f"declare it in {CROSS_METHOD_NAME}[{scope.name!r}]",
                )

    # -------------------------------------------------------------- util
    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        info = CONCURRENCY_RULES[rule]
        self.findings.append(
            Finding(
                rule=info.rule,
                name=info.name,
                severity=info.severity,
                path=self._path,
                line=getattr(node, "lineno", 0),
                message=message,
            )
        )


def analyze_concurrency_source(
    source: str, path: str | Path, keep_suppressed: bool = False
) -> list[Finding]:
    """Run every Layer-3 rule over one file's source text.
    ``keep_suppressed`` returns findings that inline disables would hide —
    the suppression auditor uses it to tell live disables from stale."""
    path = str(path)
    if file_skipped(source):
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []  # Layer 1 already reports TPU000 for unparseable files
    findings = _Collector(tree).collect(path)
    findings.sort(key=lambda f: (f.line, f.rule))
    if keep_suppressed:
        return findings
    lines = source.splitlines()
    return [f for f in findings if not is_suppressed(f, lines)]


def analyze_concurrency_paths(paths: Iterable[str | Path]) -> list[Finding]:
    """Layer-3 lint over every ``.py`` under ``paths``."""
    from mlops_tpu_torch.analysis.astrules import iter_py_files

    findings: list[Finding] = []
    for file, _rel in iter_py_files(paths):
        findings.extend(
            analyze_concurrency_source(
                file.read_text(encoding="utf-8"), file.as_posix()
            )
        )
    return findings
