"""Layer 5: async/event-loop discipline over the serve plane.

The front ends are asyncio processes whose event loop is the goodput
bottleneck under load: ONE blocking call in a coroutine stalls every
in-flight connection on that worker. Three hand-found production bugs
were exactly this class — response encode on the loop, flight-recorder
dumps fired from the loop mid-storm, blocking monitor fetches wedging
``/metrics`` — and the "event-loop confinement" discipline that fixed
them has been prose-only in server.py ever since. Layer 5 makes it
machine-checked, the same arc Layers 3 and 4 walked for locks and shm
ownership. Pure ``ast``, project-wide like Layer 4 — this module must
never import torch.

======== ============================== =======================================
ID       name                           catches
======== ============================== =======================================
TPU601   blocking-call-on-loop          a blocking call (device fetch /
                                        ``np.asarray`` / ``block_until_ready``
                                        / ``.item`` / ``.tolist`` / sync device
                                        ``.compile`` / file I/O /
                                        ``time.sleep`` / ``queue.put`` /
                                        zero-arg ``.get`` / ``.join`` /
                                        subprocess waits / sync socket ops —
                                        Layer 3's blocking table plus the
                                        loop-only extras, ONE shared
                                        classifier in ``blocking.py``) inside
                                        an event-loop-confined context, or a
                                        sync acquire of a mutex Layer 3 saw
                                        held across blocking work
TPU602   fire-and-forget-task           ``create_task``/``ensure_future``
                                        whose result is neither awaited,
                                        stored, nor used again — the asyncio
                                        "Task was destroyed but it is
                                        pending" class, and its exceptions
                                        vanish
TPU603   cross-thread-loop-write        a thread-target function writing an
                                        attribute that loop-confined code
                                        also writes, without
                                        ``call_soon_threadsafe``/
                                        ``run_coroutine_threadsafe`` and
                                        without a mutex — a data race with
                                        the loop
TPU604   await-under-sync-lock          ``await`` while a synchronous
                                        ``threading`` mutex is held — the
                                        loop may run arbitrary callbacks at
                                        the suspension point while every
                                        thread queued on the lock stalls
======== ============================== =======================================

Confinement model
-----------------
A function body is EVENT-LOOP CONFINED when it can only execute on the
asyncio thread. Seeds:

- every ``async def`` body (coroutines run on the loop by construction);
- functions registered as loop callbacks — arguments of
  ``add_done_callback`` / ``call_soon`` / ``call_later`` / ``call_at`` /
  ``call_soon_threadsafe`` / ``add_reader`` / ``add_writer`` /
  ``add_signal_handler`` (the callback runs on the loop no matter which
  thread scheduled it);
- names declared in the ``TPULINT_LOOP_CONFINED`` manifest (the
  Layer-3/4 idiom: a plain literal in the analyzed source, read with
  ``ast.literal_eval``, never imported):

      TPULINT_LOOP_CONFINED = ("HttpServer", "RingClient.on_doorbell")

  Entries are ``"Class"`` (every method), ``"Class.method"``, or a
  module-level ``"function"`` name.

Confinement then propagates to synchronous helpers REACHABLE ONLY FROM
confined contexts: a sync function with at least one project call site,
all of whose callers are confined, inherits confinement. Functions
handed to an executor or a thread (``run_in_executor(..., fn)``,
``Thread(target=fn)``, ``pool.submit(fn)``) escape the loop by
definition and never inherit — which is precisely why
``await loop.run_in_executor(None, blocking_fn)`` is the sanctioned
offload recipe and produces no finding.

The runtime twin is `analysis/loopcheck.py`: a ``LoopLagSanitizer``
that wraps the running loop's callback execution, records per-callback
wall time with attribution, asserts a max lag in tests and feeds the
production ``mlops_tpu_event_loop_lag_ms`` gauge — so the static and
dynamic halves check the same discipline, exactly like
concurrency.py/lockcheck.py do for locks.

Suppress a finding the usual way (``# tpulint: disable=TPU601`` +
justification); the TPU400 ledger audits Layer-5 disables as live/stale
like every other layer's.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator

from mlops_tpu_torch.analysis import blocking
from mlops_tpu_torch.analysis.concurrency import (
    _MUTEX_FACTORIES,
    _SEMAPHORE_FACTORIES,
    RuleInfo,
    analyze_concurrency_source,
)
from mlops_tpu_torch.analysis.findings import (
    Finding,
    Severity,
    file_skipped,
    is_suppressed,
)

# Source-level declaration name (parsed as a literal, never imported).
LOOP_CONFINED_NAME = "TPULINT_LOOP_CONFINED"

ASYNC_RULES: dict[str, RuleInfo] = {
    r.rule: r
    for r in (
        RuleInfo(
            "TPU601",
            "blocking-call-on-loop",
            Severity.ERROR,
            "blocking call inside an event-loop-confined context",
        ),
        RuleInfo(
            "TPU602",
            "fire-and-forget-task",
            Severity.ERROR,
            "task created but never awaited, stored, or observed",
        ),
        RuleInfo(
            "TPU603",
            "cross-thread-loop-write",
            Severity.ERROR,
            "thread-side write to loop-confined state without "
            "call_soon_threadsafe",
        ),
        RuleInfo(
            "TPU604",
            "await-under-sync-lock",
            Severity.ERROR,
            "await while holding a synchronous threading mutex",
        ),
    )
}

# Loop-callback registrars: any function REFERENCE passed to one of
# these runs on the event loop, whichever thread scheduled it.
_CALLBACK_REGISTRARS = {
    "add_done_callback",
    "call_soon",
    "call_later",
    "call_at",
    "call_soon_threadsafe",
    "add_reader",
    "add_writer",
    "add_signal_handler",
}
# Thread-side dispatchers: a function REFERENCE passed here executes off
# the loop (executor pool / raw thread), so it must never inherit
# confinement — and it is the TPU603 "writer role" seed.
_TASK_FACTORIES = {"create_task", "ensure_future"}
# call_soon_threadsafe / run_coroutine_threadsafe hand work TO the loop;
# their callback argument is loop-side, not thread-side.
_LOOP_HANDOFF = {"call_soon_threadsafe", "run_coroutine_threadsafe"}

_HELD_RE = re.compile(r"while holding ([A-Za-z0-9_]+(?:, [A-Za-z0-9_]+)*)")


@dataclasses.dataclass
class _Module:
    path: str
    source: str
    tree: ast.Module
    lines: list[str]


def _parse_project(items: Iterable[tuple[str, str]]) -> list[_Module]:
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
    info = ASYNC_RULES[rule]
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


# ----------------------------------------------------------- call graph
@dataclasses.dataclass
class _Fn:
    """One function in the project call graph (methods and nested defs
    are their own nodes — a nested body executes later, in whatever
    context eventually calls or schedules it)."""

    module: _Module
    node: ast.FunctionDef | ast.AsyncFunctionDef
    name: str  # leaf name
    cls: str | None  # enclosing class, if a method
    qualname: str
    is_async: bool
    confined: bool = False
    seeded: str | None = None  # why: "async" | "manifest" | "callback"
    vetoed: bool = False  # referenced as a thread/executor target


@dataclasses.dataclass(frozen=True)
class _CallSite:
    leaf: str
    self_receiver: bool
    caller: "_Fn | None"  # None: module top level (import time, not loop)
    cls: str | None  # class context of the call site


def _direct_nodes(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Every AST node lexically in ``fn_node``'s own body — nested
    function/class/lambda bodies excluded (they execute later, in their
    own context), decorators and defaults excluded (they execute at def
    time in the parent context)."""
    stack: list[ast.AST] = list(getattr(fn_node, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _leaf(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _receiver_root(node: ast.AST) -> str | None:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _Project:
    """The cross-module view: every function, every call site, every
    function reference that pins a body to the loop or to a thread."""

    def __init__(self, modules: list[_Module]) -> None:
        self.modules = modules
        self.fns: list[_Fn] = []
        self.call_sites: list[_CallSite] = []
        self.callback_leafs: set[str] = set()  # loop-callback refs
        self.thread_leafs: set[str] = set()  # thread/executor refs
        self.done_cb_leafs: set[str] = set()  # add_done_callback refs
        # names loaded OUTSIDE call position / dispatcher args: a
        # function matching one escapes (returned closure, routing
        # table, partial) and must not inherit confinement
        self.escaped_leafs: set[str] = set()
        self.manifest: set[str] = set()
        # per-class discovered lock attrs: cls -> {attr: factory dotted}
        self.locks: dict[str | None, dict[str, str]] = {}
        for module in modules:
            self._collect_module(module)
        self._collect_refs()
        self._seed_and_propagate()

    # ------------------------------------------------- collection
    def _collect_module(self, module: _Module) -> None:
        for node in module.tree.body:
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                target = node.target
            if (
                isinstance(target, ast.Name)
                and target.id == LOOP_CONFINED_NAME
                and getattr(node, "value", None) is not None
            ):
                try:
                    value = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                if isinstance(value, (list, tuple, set)):
                    self.manifest.update(str(v) for v in value)

        def visit(
            node: ast.AST, cls: str | None, parent: str
        ) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = f"{parent}.{child.name}" if parent else child.name
                    self.fns.append(
                        _Fn(
                            module=module,
                            node=child,
                            name=child.name,
                            cls=cls,
                            qualname=qual,
                            is_async=isinstance(
                                child, ast.AsyncFunctionDef
                            ),
                        )
                    )
                    visit(child, cls, qual)
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name, child.name)
                else:
                    visit(child, cls, parent)

        visit(module.tree, None, "")
        # Lock attribute discovery (self.X = threading.Lock() / module
        # LOCK = Lock()): TPU603's mutex exemption and TPU604's held set.
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
            ):
                continue
            factory = blocking.dotted(node.value.func) or ""
            if factory.split(".")[-1] not in (
                _MUTEX_FACTORIES | _SEMAPHORE_FACTORIES
            ):
                continue
            target = node.targets[0]
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                cls = self._class_of(module, node)
                self.locks.setdefault(cls, {})[target.attr] = factory
            elif isinstance(target, ast.Name):
                self.locks.setdefault(None, {})[target.id] = factory

    def _class_of(self, module: _Module, node: ast.AST) -> str | None:
        # lexical containment by line span — cheap and good enough for
        # "which class does this self.X = Lock() belong to"
        best: str | None = None
        best_span = None
        for cand in ast.walk(module.tree):
            if not isinstance(cand, ast.ClassDef):
                continue
            end = getattr(cand, "end_lineno", cand.lineno)
            if cand.lineno <= node.lineno <= end:
                span = end - cand.lineno
                if best_span is None or span < best_span:
                    best, best_span = cand.name, span
        return best

    def _collect_refs(self) -> None:
        """Walk every function body once: record call sites (for
        propagation) and function references that pin execution context
        (loop callbacks vs thread targets)."""

        def scan_owner(
            owner: _Fn | None, cls: str | None, nodes: list[ast.AST]
        ) -> None:
            consumed: set[int] = set()  # func positions + dispatcher args
            for node in nodes:
                if isinstance(node, ast.Call):
                    consumed.add(id(node.func))
            for node in nodes:
                if not isinstance(node, ast.Call):
                    if (
                        isinstance(node, (ast.Name, ast.Attribute))
                        and isinstance(node.ctx, ast.Load)
                        and id(node) not in consumed
                    ):
                        escaped = _leaf(node)
                        if escaped:
                            self.escaped_leafs.add(escaped)
                    continue
                leaf = _leaf(node.func)
                if leaf is None:
                    continue
                self.call_sites.append(
                    _CallSite(
                        leaf=leaf,
                        self_receiver=(
                            isinstance(node.func, ast.Attribute)
                            and _receiver_root(node.func.value) == "self"
                            and isinstance(node.func.value, ast.Name)
                        ),
                        caller=owner,
                        cls=cls,
                    )
                )
                refs = [
                    a for a in node.args
                    if isinstance(a, (ast.Name, ast.Attribute))
                ]
                if leaf in _CALLBACK_REGISTRARS:
                    for ref in refs:
                        ref_leaf = _leaf(ref)
                        if ref_leaf:
                            self.callback_leafs.add(ref_leaf)
                            if leaf == "add_done_callback":
                                self.done_cb_leafs.add(ref_leaf)
                if leaf in _LOOP_HANDOFF:
                    for ref in refs:
                        ref_leaf = _leaf(ref)
                        if ref_leaf:
                            self.callback_leafs.add(ref_leaf)
                elif leaf == "run_in_executor" and len(node.args) >= 2:
                    ref_leaf = _leaf(node.args[1])
                    if ref_leaf:
                        self.thread_leafs.add(ref_leaf)
                elif leaf == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            ref_leaf = _leaf(kw.value)
                            if ref_leaf:
                                self.thread_leafs.add(ref_leaf)
                elif leaf == "submit" and node.args:
                    # pool.submit(fn, ...): only when the receiver reads
                    # like an executor — the ring has a submit() too.
                    recv = (
                        blocking.dotted(node.func.value) or ""
                        if isinstance(node.func, ast.Attribute)
                        else ""
                    )
                    if "executor" in recv.lower() or "pool" in recv.lower():
                        ref_leaf = _leaf(node.args[0])
                        if ref_leaf:
                            self.thread_leafs.add(ref_leaf)

        for fn in self.fns:
            scan_owner(fn, fn.cls, list(_direct_nodes(fn.node)))
        for module in self.modules:
            # module top level: call sites here run at import time
            stack: list[ast.AST] = list(module.tree.body)
            flat: list[ast.AST] = []
            while stack:
                node = stack.pop()
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Lambda)
                ):
                    continue
                flat.append(node)
                stack.extend(ast.iter_child_nodes(node))
            scan_owner(None, None, flat)

    # ------------------------------------------------ confinement
    def _manifest_match(self, fn: _Fn) -> bool:
        if fn.cls is not None:
            return (
                fn.cls in self.manifest
                or f"{fn.cls}.{fn.name}" in self.manifest
            )
        return fn.name in self.manifest

    def _seed_and_propagate(self) -> None:
        for fn in self.fns:
            fn.vetoed = fn.name in self.thread_leafs
            if fn.is_async:
                fn.confined, fn.seeded = True, "async"
            elif self._manifest_match(fn):
                # explicit declaration wins over the thread-ref veto
                fn.confined, fn.seeded = True, "manifest"
            elif not fn.vetoed and fn.name in self.callback_leafs:
                fn.confined, fn.seeded = True, "callback"
        # callers[leaf] -> every site that could target a fn by leaf name
        sites_by_leaf: dict[str, list[_CallSite]] = {}
        for site in self.call_sites:
            sites_by_leaf.setdefault(site.leaf, []).append(site)
        changed = True
        while changed:
            changed = False
            for fn in self.fns:
                if fn.confined or fn.vetoed:
                    continue
                if fn.name in self.escaped_leafs:
                    continue  # a bare reference escapes the call graph
                sites = [
                    s
                    for s in sites_by_leaf.get(fn.name, ())
                    if not (s.self_receiver and s.cls != fn.cls)
                ]
                if not sites:
                    continue
                if all(
                    s.caller is not None and s.caller.confined
                    for s in sites
                ):
                    fn.confined = True
                    changed = True


# ------------------------------------------------------------- TPU601
def _hot_mutexes(module: _Module) -> set[str]:
    """Lock names Layer 3 saw held across blocking work in this module
    (suppressed findings included: a justified TPU403 still means the
    mutex stalls, so acquiring it on the loop is still a stall)."""
    names: set[str] = set()
    for finding in analyze_concurrency_source(
        module.source, module.path, keep_suppressed=True
    ):
        if finding.rule != "TPU403":
            continue
        match = _HELD_RE.search(finding.message)
        if match:
            names.update(
                n.strip() for n in match.group(1).split(",") if n.strip()
            )
    return names


def _check_blocking_on_loop(
    project: _Project, findings: list[Finding]
) -> None:
    hot_by_module: dict[str, set[str]] = {}
    for fn in project.fns:
        if not fn.confined:
            continue
        module = fn.module
        hot = hot_by_module.get(module.path)
        if hot is None:
            hot = hot_by_module.setdefault(module.path, _hot_mutexes(module))
        params = {
            a.arg
            for a in (
                fn.node.args.args
                + fn.node.args.posonlyargs
                + fn.node.args.kwonlyargs
            )
        }
        is_done_cb = fn.name in project.done_cb_leafs
        awaited: set[int] = set()
        for node in _direct_nodes(fn.node):
            if isinstance(node, ast.Await):
                # the whole awaited subtree is suspension, not blocking:
                # inner calls (wait_for(self._full.wait(), t), gather,
                # shield) build coroutine objects, they don't run here
                awaited.update(id(sub) for sub in ast.walk(node.value))
                continue
            if isinstance(node, ast.With):
                for item in node.items:
                    ctx = item.context_expr
                    leaf = _leaf(ctx)
                    if leaf in hot and (
                        isinstance(ctx, ast.Name)
                        or _receiver_root(ctx) == "self"
                    ):
                        _flag(
                            findings,
                            "TPU601",
                            module.path,
                            node.lineno,
                            f"sync acquire of {leaf!r} on the event loop: "
                            "Layer 3 saw this mutex held across blocking "
                            "work, so the loop can stall behind it — "
                            "offload via loop.run_in_executor or restructure"
                            " the critical section",
                        )
                continue
            if not isinstance(node, ast.Call):
                continue
            if id(node) in awaited:
                continue  # awaited calls suspend, they don't block
            leaf = _leaf(node.func)
            if (
                leaf == "acquire"
                and isinstance(node.func, ast.Attribute)
                and _leaf(node.func.value) in hot
            ):
                _flag(
                    findings,
                    "TPU601",
                    module.path,
                    node.lineno,
                    f"blocking .acquire() of "
                    f"{_leaf(node.func.value)!r} on the event loop: "
                    "Layer 3 saw this mutex held across blocking work — "
                    "offload via loop.run_in_executor",
                )
                continue
            if (
                is_done_cb
                and leaf in {"result", "exception"}
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params
            ):
                # done-callback reading its (completed) future: no wait
                continue
            label = blocking.classify_blocking(node, loop_context=True)
            if label is not None:
                why = (
                    f"in async {fn.qualname!r}"
                    if fn.is_async
                    else f"in {fn.qualname!r} (reachable only from "
                    "event-loop-confined contexts)"
                )
                _flag(
                    findings,
                    "TPU601",
                    module.path,
                    node.lineno,
                    f"{label} {why} stalls every in-flight connection on "
                    "this worker — offload it: "
                    "await loop.run_in_executor(executor, fn, *args)",
                )


# ------------------------------------------------------------- TPU602
def _check_fire_and_forget(
    project: _Project, findings: list[Finding]
) -> None:
    attr_reads: dict[tuple[str, str | None], set[str]] = {}
    for fn in project.fns:
        key = (fn.module.path, fn.cls)
        reads = attr_reads.setdefault(key, set())
        for node in _direct_nodes(fn.node):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)
            ):
                reads.add(node.attr)
    for fn in project.fns:
        for node in _direct_nodes(fn.node):
            if (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and _leaf(node.value.func) in _TASK_FACTORIES
            ):
                _flag(
                    findings,
                    "TPU602",
                    fn.module.path,
                    node.lineno,
                    f"{_leaf(node.value.func)}() result discarded: the "
                    "task can be garbage-collected mid-flight ('Task was "
                    "destroyed but it is pending') and its exception is "
                    "never observed — store a strong reference and "
                    "await/cancel it, or add_done_callback that logs "
                    "errors",
                )
                continue
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
                and _leaf(node.value.func) in _TASK_FACTORIES
            ):
                continue
            factory = _leaf(node.value.func)
            target = node.targets[0]
            if isinstance(target, ast.Name):
                used = any(
                    isinstance(other, ast.Name)
                    and other.id == target.id
                    and other is not target
                    for other in _direct_nodes(fn.node)
                )
                if not used:
                    _flag(
                        findings,
                        "TPU602",
                        fn.module.path,
                        node.lineno,
                        f"{factory}() assigned to {target.id!r} but the "
                        "name is never used again — the reference dies "
                        "with this frame and the task becomes "
                        "fire-and-forget; await it, keep it in a "
                        "collection, or add an error-logging done-callback",
                    )
            elif (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                key = (fn.module.path, fn.cls)
                if target.attr not in attr_reads.get(key, set()):
                    _flag(
                        findings,
                        "TPU602",
                        fn.module.path,
                        node.lineno,
                        f"{factory}() stored on self.{target.attr} but no "
                        "method of this class ever reads it — the task is "
                        "unobserved; await/cancel it somewhere or attach "
                        "an error-logging done-callback",
                    )


# ------------------------------------------------------------- TPU603
def _check_cross_thread_writes(
    project: _Project, findings: list[Finding]
) -> None:
    # loop-confined attrs per (module, class): attrs written via self in
    # confined methods — __init__ excluded (construction precedes
    # concurrency), lock attrs excluded (they ARE the synchronization).
    confined_attrs: dict[tuple[str, str], set[str]] = {}
    for fn in project.fns:
        if not fn.confined or fn.cls is None:
            continue
        if fn.name in {"__init__", "__post_init__"}:
            continue
        lock_names = set(project.locks.get(fn.cls, ()))
        attrs = confined_attrs.setdefault((fn.module.path, fn.cls), set())
        for node in _direct_nodes(fn.node):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for target in targets:
                if isinstance(target, ast.Subscript):
                    target = target.value
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and target.attr not in lock_names
                ):
                    attrs.add(target.attr)
    for fn in project.fns:
        if fn.cls is None or fn.confined:
            continue
        if fn.name not in project.thread_leafs:
            continue
        attrs = confined_attrs.get((fn.module.path, fn.cls), set())
        if not attrs:
            continue
        lock_names = set(project.locks.get(fn.cls, ()))

        def walk(stmts: list[ast.stmt], held: bool) -> None:
            for stmt in stmts:
                if isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)
                ):
                    continue
                if isinstance(stmt, ast.With):
                    inner_held = held or any(
                        _leaf(item.context_expr) in lock_names
                        for item in stmt.items
                    )
                    walk(stmt.body, inner_held)
                    continue
                targets: list[ast.AST] = []
                if isinstance(stmt, ast.Assign):
                    targets = list(stmt.targets)
                elif isinstance(stmt, ast.AugAssign):
                    targets = [stmt.target]
                elif (
                    isinstance(stmt, ast.AnnAssign)
                    and stmt.value is not None
                ):
                    targets = [stmt.target]
                if not held:
                    for target in targets:
                        if isinstance(target, ast.Subscript):
                            target = target.value
                        if (
                            isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                            and target.attr in attrs
                        ):
                            _flag(
                                findings,
                                "TPU603",
                                fn.module.path,
                                stmt.lineno,
                                f"thread-target {fn.qualname!r} writes "
                                f"self.{target.attr}, which "
                                "loop-confined code also writes — a data "
                                "race with the event loop; marshal the "
                                "update through "
                                "loop.call_soon_threadsafe (or guard "
                                "both sides with one mutex)",
                            )
                for field in ("body", "orelse", "finalbody"):
                    walk(getattr(stmt, field, []) or [], held)
                for handler in getattr(stmt, "handlers", []) or []:
                    walk(handler.body, held)

        walk(list(fn.node.body), False)


# ------------------------------------------------------------- TPU604
def _sync_mutexes(project: _Project, cls: str | None) -> set[str]:
    """Discovered mutex attrs that are SYNCHRONOUS (threading, not
    asyncio — an ``async with`` coroutine lock never blocks the loop)."""
    out: set[str] = set()
    for scope in (cls, None):
        for name, factory in project.locks.get(scope, {}).items():
            root = factory.split(".")[0]
            leaf = factory.split(".")[-1]
            if root != "asyncio" and leaf in _MUTEX_FACTORIES:
                out.add(name)
    return out


def _check_await_under_lock(
    project: _Project, findings: list[Finding]
) -> None:
    for fn in project.fns:
        if not fn.is_async:
            continue
        mutexes = _sync_mutexes(project, fn.cls)
        if not mutexes:
            continue

        def walk(stmts: list[ast.stmt], held: frozenset[str]) -> None:
            for stmt in stmts:
                if isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)
                ):
                    continue
                if isinstance(stmt, ast.With):
                    acquired = {
                        leaf
                        for item in stmt.items
                        if (leaf := _leaf(item.context_expr)) in mutexes
                        and (
                            isinstance(item.context_expr, ast.Name)
                            or _receiver_root(item.context_expr) == "self"
                        )
                    }
                    walk(stmt.body, held | acquired)
                    continue
                inner = held
                if isinstance(stmt, ast.Expr) and isinstance(
                    stmt.value, ast.Call
                ):
                    call = stmt.value
                    if isinstance(call.func, ast.Attribute):
                        recv = _leaf(call.func.value)
                        if call.func.attr == "acquire" and recv in mutexes:
                            held = held | {recv}
                        elif (
                            call.func.attr == "release" and recv in mutexes
                        ):
                            held = held - {recv}
                if held or inner:
                    scan_awaits_shallow(stmt, held | inner)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        walk(sub, held)
                for handler in getattr(stmt, "handlers", []) or []:
                    walk(handler.body, held)

        def scan_awaits_shallow(
            stmt: ast.AST, held: frozenset[str]
        ) -> None:
            # only this statement's own expressions — child statement
            # lists are walked separately with their own held set
            stack: list[ast.AST] = []
            for child in ast.iter_child_nodes(stmt):
                if not isinstance(child, ast.stmt):
                    stack.append(child)
            while stack:
                node = stack.pop()
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)
                ):
                    continue
                if isinstance(node, ast.Await):
                    _flag(
                        findings,
                        "TPU604",
                        fn.module.path,
                        node.lineno,
                        f"await while holding "
                        f"{', '.join(sorted(held))}: the loop runs "
                        "arbitrary callbacks at this suspension point "
                        "while every thread queued on the mutex stalls — "
                        "release before awaiting, or use an asyncio lock",
                    )
                for child in ast.iter_child_nodes(node):
                    if not isinstance(child, ast.stmt):
                        stack.append(child)

        walk(list(fn.node.body), frozenset())


# ---------------------------------------------------------- entry points
def _analyze_project(
    modules: list[_Module], keep_suppressed: bool
) -> list[Finding]:
    project = _Project(modules)
    findings: list[Finding] = []
    _check_blocking_on_loop(project, findings)
    _check_fire_and_forget(project, findings)
    _check_cross_thread_writes(project, findings)
    _check_await_under_lock(project, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if keep_suppressed:
        return findings
    lines_by_path = {m.path: m.lines for m in modules}
    return [
        f
        for f in findings
        if not is_suppressed(f, lines_by_path.get(f.path, []))
    ]


def analyze_async_project(
    items: Iterable[tuple[str, str]], keep_suppressed: bool = False
) -> list[Finding]:
    """Layer-5 lint over ``(path, source)`` pairs as ONE project — the
    mutation-test entry point: callers can edit a file in memory (e.g.
    strip an executor offload) and re-analyze without touching disk."""
    return _analyze_project(_parse_project(items), keep_suppressed)


def analyze_async_source(
    source: str, path: str | Path = "<memory>",
    keep_suppressed: bool = False,
) -> list[Finding]:
    """Run every Layer-5 rule over one file as a single-file project —
    the fixture/test entry point. Confinement propagation obviously sees
    only this file's call graph and manifest."""
    return analyze_async_project([(str(path), source)], keep_suppressed)


def analyze_async_paths(
    paths: Iterable[str | Path], keep_suppressed: bool = False
) -> list[Finding]:
    """Layer-5 lint over every ``.py`` under ``paths`` as ONE project."""
    from mlops_tpu_torch.analysis.astrules import iter_py_files

    items: list[tuple[str, str]] = []
    for file, _rel in iter_py_files(list(paths)):
        items.append((file.as_posix(), file.read_text(encoding="utf-8")))
    return analyze_async_project(items, keep_suppressed)
