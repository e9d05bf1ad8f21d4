"""Layer 2: aten-graph checks over the registered programs.

Each entry point (``analysis/entrypoints.py``) wraps a REAL production
factory and is traced with ``torch.fx.experimental.proxy_tensor.make_fx
(..., tracing_mode="fake")`` on schema-derived fake batches: the trace
runs every op on ``FakeTensor``s (shapes and dtypes only), so no device
code executes and no kernel launches, yet the aten graph is the program
the factory runs. A run reads every ``LaunchCounter`` before and after
and reports (TPU306) any that moved.

Checks (rule ids continue the tpulint catalog):

- **TPU301 float64-leak**: an f64 value anywhere in the traced program:
  the H100's f64 rate is a small fraction of its f32 one, and it marks an
  unintended widening. An entry that declares f64 as its contract (the
  gbm tier's traversal, bit for bit with sklearn's f64 compares) is
  exempt.
- **TPU302 weak-type-output**: no PyTorch meaning. JAX marks Python
  scalars weakly typed; a torch tensor's dtype is always concrete, so no
  output can change the call's signature on its way back in.
- **TPU303 to-copy-round-trip**: an ``aten._to_copy`` chained onto
  another whose output dtype returns to the first one's input dtype: a
  wasted cast pair (a declared f64 entry may round-trip through f64).
- **TPU304 bucket-shape-polymorphism**: the aten op sequence differs
  across the declared warmup buckets of one family, so each bucket's
  captured graph is a different program, not the same one at another
  shape.
- **TPU305 layout-link-mismatch**: a declared producer->consumer link
  (the train step's packaged params, the serving engine's layout) whose
  ``PARAM_RULES`` / ``layout_specs`` disagree.
- **TPU306 entry-point-trace-failure**: the entry did not trace, or a
  launch counter moved during the run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from mlops_tpu_torch.analysis.findings import Finding, Severity

TRACE_RULES = {
    "TPU301": ("float64-leak", Severity.ERROR),
    "TPU303": ("to-copy-round-trip", Severity.WARNING),
    "TPU304": ("bucket-shape-polymorphism", Severity.ERROR),
    "TPU305": ("layout-link-mismatch", Severity.ERROR),
    "TPU306": ("entry-point-trace-failure", Severity.ERROR),
}


@dataclasses.dataclass
class EntryPoint:
    """One registered program.

    ``build(device)`` runs inside the trace's ``FakeTensorMode`` and
    returns ``(fn, args_by_bucket)``: ``args_by_bucket`` maps a bucket to
    the arguments (fake tensors, dicts, dataclasses of them) ``fn`` is
    traced with. ``min_ranks`` gates entries that need a process group of
    that many ranks; they are reported as skipped, never dropped.
    ``device`` says whether the entry follows the requested device
    (``"any"``) or always traces on the CPU (``"cpu"``: the quant tier's
    plain route, as the JAX package traces its jnp composite).
    """

    name: str
    build: Callable[[str], tuple[Callable, dict[int, tuple]]]
    min_ranks: int = 1
    # Declared layout contract for TPU305 links: ``{param: spec}`` (or
    # None: dense, replicated), produced / consumed; a callable is
    # evaluated when the link is checked.
    params_out_spec: Any = None
    params_in_spec: Any = None
    # Buckets in the SAME tuple must trace to the identical op sequence
    # (TPU304); buckets in different tuples are known distinct programs.
    # None = all buckets are one family.
    bucket_families: tuple[tuple[int, ...], ...] | None = None
    # Declared f64 entry (the gbm tier): TPU301 skipped, f64-endpoint
    # round trips allowed.
    x64: bool = False
    device: str = "any"


@dataclasses.dataclass(frozen=True)
class ShardingLink:
    """Producer's packaged params feed the consumer. ``transport`` is
    ``"as-is"`` (the layouts must agree) or ``"shard-at-load"`` (the
    producer packages dense params and the consumer lays them out itself:
    compared only when the producer declares a layout)."""

    producer: str
    consumer: str
    transport: str = "as-is"


def _flag(rule: str, entry: str, message: str, bucket: int = 0) -> Finding:
    name, severity = TRACE_RULES[rule]
    return Finding(
        rule=rule,
        name=name,
        severity=severity,
        path=f"<trace:{entry}>",
        line=bucket,
        message=message,
    )


def _flatten(value: Any, leaves: list) -> Callable[[list], Any]:
    """Collect the tensors of ``value`` (nested dicts, lists, tuples and
    dataclasses) into ``leaves``; return the function that rebuilds it
    from a list of replacements."""
    import torch

    if isinstance(value, torch.Tensor):
        i = len(leaves)
        leaves.append(value)
        return lambda new: new[i]
    if isinstance(value, dict):
        parts = {k: _flatten(v, leaves) for k, v in value.items()}
        return lambda new: {k: f(new) for k, f in parts.items()}
    if isinstance(value, (list, tuple)):
        parts = [_flatten(v, leaves) for v in value]
        kind = type(value)
        return lambda new: kind(f(new) for f in parts)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        parts = {f.name: _flatten(getattr(value, f.name), leaves)
                 for f in dataclasses.fields(value)}
        kind = type(value)
        return lambda new: kind(**{k: f(new) for k, f in parts.items()})
    return lambda new: value


def trace_program(fn: Callable, args: tuple):
    """The aten graph of ``fn(*args)``, every tensor of ``args`` (nested
    in dicts, tuples and dataclasses) a graph input, traced on fake
    tensors."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves: list = []
    rebuild = _flatten(tuple(args), leaves)

    def flat(*tensors):
        return fn(*rebuild(list(tensors)))

    return make_fx(flat, tracing_mode="fake")(*leaves)


def _calls(graph_module) -> list:
    return [n for n in graph_module.graph.nodes if n.op == "call_function"]


def op_signature(graph_module) -> tuple[str, ...]:
    """The bucket-invariant fingerprint of a program: its aten ops in
    order. Shapes are excluded: they SHOULD differ across buckets."""
    return tuple(str(n.target) for n in _calls(graph_module))


def _dtype(node) -> Any:
    return getattr(node.meta.get("val"), "dtype", None)


def check_dtypes(entry_name: str, bucket: int, graph_module,
                 x64_entry: bool = False) -> list[Finding]:
    """TPU301 (f64 anywhere) and TPU303 (``_to_copy`` round trips)."""
    import torch

    findings: list[Finding] = []
    calls = _calls(graph_module)
    f64_hits = sum(_dtype(n) == torch.float64 for n in calls)
    if f64_hits and not x64_entry:
        findings.append(_flag(
            "TPU301", entry_name,
            f"{f64_hits} float64 value(s) in the traced program — an "
            "unintended widening (the H100's f64 rate is a fraction of "
            "its f32 one); pin dtypes at the boundary",
            bucket,
        ))
    for node in calls:
        if str(node.target) != "aten._to_copy.default" or not node.args:
            continue
        src = node.args[0]
        if getattr(src, "op", None) != "call_function" or str(src.target) != "aten._to_copy.default":
            continue
        start = _dtype(src.args[0]) if src.args and hasattr(src.args[0], "meta") else None
        middle, end = _dtype(src), _dtype(node)
        if (
            start is not None
            and start == end
            and middle != start
            and not (x64_entry and torch.float64 in (start, middle))
        ):
            findings.append(_flag(
                "TPU303", entry_name,
                f"_to_copy round-trip {start}->{middle}->{end} — a wasted "
                "cast pair (a dtype discipline bug or a missing fused op)",
                bucket,
            ))
    return findings


def check_bucket_stability(
    entry_name: str,
    graphs_by_bucket: dict[int, Any],
    families: tuple[tuple[int, ...], ...] | None = None,
) -> list[Finding]:
    """TPU304: the op sequence must be identical across the buckets of
    each declared family (all buckets, when none are declared)."""
    if families is None:
        families = (tuple(sorted(graphs_by_bucket)),)
    findings = []
    declared = {b for family in families for b in family}
    for bucket in sorted(set(graphs_by_bucket) - declared):
        findings.append(_flag(
            "TPU304", entry_name,
            f"bucket {bucket} is traced but belongs to no declared bucket "
            "family — add it to the entry's bucket_families so its shape "
            "stability is checked",
            bucket,
        ))
    for family in families:
        present = [b for b in family if b in graphs_by_bucket]
        if len(present) < 2:
            continue
        reference = op_signature(graphs_by_bucket[present[0]])
        for bucket in present[1:]:
            sig = op_signature(graphs_by_bucket[bucket])
            if sig == reference:
                continue
            diff_at = next(
                (i for i, (a, b) in enumerate(zip(reference, sig)) if a != b),
                min(len(reference), len(sig)),
            )
            findings.append(_flag(
                "TPU304", entry_name,
                f"program shape-polymorphic across buckets {present[0]} vs "
                f"{bucket}: {len(reference)} vs {len(sig)} aten ops, first "
                f"divergence at op {diff_at} — each bucket captures a "
                "different program, breaking the padded-bucket contract",
                bucket,
            ))
    return findings


def _spec_items(spec: Any) -> list[tuple[str, str]]:
    spec = spec() if callable(spec) else spec
    if spec is None:
        return []
    return sorted((str(k), str(tuple(v))) for k, v in dict(spec).items())


def check_sharding_links(
    entries: dict[str, EntryPoint], links: list[ShardingLink]
) -> list[Finding]:
    """TPU305 over the declared producer->consumer links."""
    findings = []
    for link in links:
        producer = entries.get(link.producer)
        consumer = entries.get(link.consumer)
        if producer is None or consumer is None:
            continue  # entry skipped (ranks): reported elsewhere
        out_spec = _spec_items(producer.params_out_spec)
        if link.transport == "shard-at-load" and not out_spec:
            continue
        in_spec = _spec_items(consumer.params_in_spec)
        if out_spec == in_spec:
            continue
        mismatched = [
            f"{po} produces {so}, consumer expects {si}"
            for (po, so), (pi, si) in zip(out_spec, in_spec)
            if so != si or po != pi
        ][:3] or [f"{len(out_spec)} vs {len(in_spec)} param layouts"]
        findings.append(_flag(
            "TPU305", f"{link.producer}->{link.consumer}",
            f"param layout mismatch over {link.transport!r} transport: "
            + "; ".join(mismatched)
            + " — the consumer re-lays the params out on every handoff",
        ))
    return findings


def _launch_counts() -> list[tuple[Any, int]]:
    # Every module that makes a counter, so each is read before the run.
    import mlops_tpu_torch.ops.attention  # noqa: F401
    import mlops_tpu_torch.ops.gbm_tensor  # noqa: F401
    import mlops_tpu_torch.ops.quant_kernel  # noqa: F401
    import mlops_tpu_torch.parallel.collectives  # noqa: F401
    from mlops_tpu_torch.ops.cuda_build import LAUNCH_COUNTERS

    return [(c, c.value) for c in LAUNCH_COUNTERS]


def run_trace_checks(
    entries: list[EntryPoint] | None = None,
    links: list[ShardingLink] | None = None,
    device: str = "cpu",
) -> tuple[list[Finding], list[str]]:
    """Trace every available entry on ``device`` fakes and run every
    check. Returns ``(findings, notes)``: notes record skipped entries,
    per-entry trace stats and the launch counters' verdict."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    if entries is None or links is None:
        from mlops_tpu_torch.analysis import entrypoints

        entries = entrypoints.registered_entry_points() if entries is None else entries
        links = entrypoints.LINKS if links is None else links

    ranks = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    before = _launch_counts()
    findings: list[Finding] = []
    notes: list[str] = []
    traced: dict[str, EntryPoint] = {}
    for entry in entries:
        if ranks < entry.min_ranks:
            notes.append(
                f"skipped {entry.name}: needs a process group of >= "
                f"{entry.min_ranks} ranks, have {ranks} (launch under "
                "torch.distributed.run)"
            )
            continue
        where = "cpu" if entry.device == "cpu" else device
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args_by_bucket = entry.build(where)
                graphs = {
                    bucket: trace_program(fn, args)
                    for bucket, args in args_by_bucket.items()
                }
        # Any trace failure IS the finding (TPU306): nothing is swallowed.
        except Exception as err:  # tpulint: disable=TPU201
            findings.append(_flag(
                "TPU306", entry.name,
                f"entry point failed to trace on fake tensors: "
                f"{type(err).__name__}: {err}",
            ))
            continue
        traced[entry.name] = entry
        ops = len(op_signature(next(iter(graphs.values()))))
        notes.append(
            f"traced {entry.name} on {where}: buckets {sorted(graphs)} "
            f"({ops} aten ops, fake tensors — no device code executed)"
        )
        for bucket, graph in graphs.items():
            findings.extend(check_dtypes(entry.name, bucket, graph, x64_entry=entry.x64))
        findings.extend(check_bucket_stability(entry.name, graphs, entry.bucket_families))
    findings.extend(check_sharding_links(traced, links))
    moved = [(c.name, n, c.value) for c, n in before if c.value != n]
    if moved:
        findings.append(_flag(
            "TPU306", "launch-counters",
            "launch counters moved during the trace run (device code "
            "executed): " + ", ".join(f"{name} {a}->{b}" for name, a, b in moved),
        ))
    else:
        notes.append(f"launch counters unchanged across the trace run "
                     f"({len(before)} counters)")
    return findings, notes
