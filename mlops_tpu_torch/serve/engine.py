"""Inference engine: bundle -> warmed, bucketed, fused predict, on the
exact, the quant or the gbm tier, or on exact and quant with per-request
tier routing, or on the host hybrid of the sklearn floor.

Port of the JAX package's ``serve/engine.py`` for its single-device
tiers:

- the tier table ``exact | quant | auto`` (``_resolve_tier``): exact is
  the default, quant is a demand (raise rather than serve other bits than
  asked for), auto takes a gated quant tier and otherwise falls back to
  exact, logging why. With ``tier_routing`` the engine also holds the
  bundle's other gated tier (``_extra_tier``), and each dispatch names the
  tier it runs (``route_tier`` maps an SLO class to one);
- an ``sklearn`` bundle serves its HistGBM ensemble on the gbm tier
  (``ops/gbm_tensor.py``: f64 tree tensors and a f64 temperature on the
  device, the packed contract, grouping, the accumulator and the CUDA
  graphs of every tier; one tier, so every SLO class routes to it), and
  an ensemble that does not tensorize (rf) on the host hybrid
  (``ops/predict.py make_hybrid_predict_fn``): the trees on the host, the
  monitors on the device, no grouping, no graphs and no accumulator (the
  server folds its monitor totals on the host), refused by hot swaps;
- requests pad up to the nearest row bucket (1, 8, 64, 256 by default)
  with a validity mask, so drift and outlier statistics ignore padding;
  concurrent small requests group into one ``[slots, rows]`` dispatch
  (``dispatch_group``, which the micro-batcher calls);
- one packed program per dispatch: on the exact tier the model, flags,
  drift and fold in plain PyTorch (``ops/predict.py``), on the quant tier
  one CUDA kernel launch plus the p-value tail (``ops/quant_kernel.py``);
- on the card, ``warmup`` captures every (tier, bucket) and (tier, group
  geometry) program into one CUDA graph (``serve/graphs.py``), and every
  dispatch replays one: no eager program serves traffic there (a shape
  warmup did not cover is captured on first use, under the lock). The CPU
  runs the programs eagerly: the route the caller asked for;
- the device -> host surface is ONE packed f32 buffer per dispatch
  (predictions ‖ outlier flags ‖ drift), copied into pinned host memory
  behind a CUDA event; fetch waits on that event;
- the running monitor aggregate is one static device buffer that every
  program of every tier folds into in place. ``monitor_snapshot`` reads it
  off the request path (fetch-and-reset into f64 host totals; a window
  whose fetch fails folds back into the live one);
- bundle turnover for the lifecycle loop (``lifecycle/``): a tee hands
  each request's encoded rows to the controller, ``swap_bundle``
  hot-promotes a candidate engine's bundle (its programs captured again
  over this engine's accumulator before one reference exchange under the
  lock) and ``rollback`` exchanges back;
- grid turnover for the autotuner (``autotune/``): ``warm_grid`` readies
  a plan's missing buckets on every tier of the serving generation, one
  capture per lock hold, and ``regrid`` exchanges in a generation that
  differs only in its bucket list and shares the graphs (or the eager
  route's ready set) by reference, so a dispatch that picked its bucket
  from the old grid still replays a graph that exists; ``grid_generation``
  counts the swaps and rollbacks that changed the bucket list;
- observability (``trace/``, ``slo/``): with tracing armed a request's
  span gets the engine-side stamps (``encode``, ``dispatch`` when the
  replay and the copy to the host are enqueued, ``device_fetch`` when the
  pinned host buffer is complete) and every dispatch feeds the shape
  histograms (``set_shape_stats``); with ``slo.ledger_dir`` every dispatch
  bills its entry's dispatch -> fetch host seconds to the cost ledger
  (``set_cost_ledger``), keyed by entry and model fingerprint;
- the degraded-bucket fallback: a shape warmup did not ready (no graph
  on the card, never run on the CPU route) is captured (or run once) at
  dispatch under the ``serve.engine.compile`` fault point; when that
  fails, the dispatch serves through the smallest larger ready shape of
  the same tier, padding masked (the answer is bitwise the target
  shape's), and ``degraded_dispatch_total`` counts it. With no larger
  ready shape the failure raises;
- sharded serving (``serve.model_shards = S``, the JAX engine's
  ``model_shards`` branch): given a ('model',) ``ServeMesh`` over S ranks,
  one card each (``parallel/sharding.serve_mesh``), the exact tier's
  params are laid out by ``PARAM_RULES`` (``parallel/steps.py
  layout_specs`` / ``shard_model``: Megatron column and row cuts,
  attention heads, MoE experts) and each rank commits only its blocks;
  the monitor, the accumulator, the temperature and the batch are
  replicated, and every rank folds the same values. The layers' row cuts
  all-reduce over the mesh (NCCL on the card, inside each CUDA graph;
  gloo on the CPU). Rank 0, the lead, owns dispatch and fetch; before it
  runs any operation that holds collectives it announces it on the
  mesh, under the mesh's one lock, and every follower rank runs the same
  operation on its own engine (``follow_op``, driven by
  ``serve/shards.py::follow``): dispatches, warm passes and captures,
  swaps, regrids, rollbacks and monitor reads, so the collectives, and
  the graph replays holding them, match across ranks; a shape counts as
  ready once every rank has readied it (``ServeMesh.agree``). Under
  S > 1 the quant tier is refused (``auto`` falls back to exact); the gbm
  tier and the host hybrid ignore the mesh, as the JAX engine ignores the
  knob for sklearn bundles.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import json
import logging
import threading
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from mlops_tpu_torch import faults
from mlops_tpu_torch.bundle.bundle import Bundle
from mlops_tpu_torch.device import held_stream, resolve_device
from mlops_tpu_torch.monitor.state import (
    MonitorAccumulator,
    MonitorState,
    init_accumulator,
)
from mlops_tpu_torch.ops.gbm_tensor import (
    gbm_graph_replays,
    make_gbm_grouped_base,
    make_gbm_packed_base,
)
from mlops_tpu_torch.ops.predict import (
    make_hybrid_predict_fn,
    make_packed_grouped_base,
    make_packed_predict_base,
    model_params,
    packed_layout,
)
from mlops_tpu_torch.ops.quant_kernel import (
    make_quant_grouped_base,
    make_quant_packed_base,
)
from mlops_tpu_torch.parallel.collectives import COLLECTIVE_CALLS
from mlops_tpu_torch.parallel.sharding import MeshOutOfStep, sharded_axes
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.schema.validate import records_to_columns
from mlops_tpu_torch.serve import graphs
from mlops_tpu_torch.serve.tierroute import TIERS, tier_for_class
from mlops_tpu_torch.serve.wire import (
    EMPTY_RESPONSE_BYTES,
    GROUP_ROW_BUCKET,
    GROUP_ROW_BUCKETS,
    GROUP_SLOT_BUCKETS,
    empty_response,
    encode_response,
    format_response,
)
from mlops_tpu_torch.slo.ledger import model_tag
from mlops_tpu_torch.weights import gbm_variables_from_numpy

logger = logging.getLogger(__name__)
TIER_NAMES = ("exact", "quant", "auto")
_D = SCHEMA.num_categorical + SCHEMA.num_numeric


def _entry_name(base: str, tier: str, gen: "_Generation") -> str:
    """A dispatch's entry label, as the JAX package names its compiled
    entries: the geometry, suffixed with the tier for non-default tiers
    only."""
    return base if tier == gen.default_tier else f"{base}@{tier}"


@dataclasses.dataclass(frozen=True)
class _Tier:
    """One servable tier: its committed params and temperature on the
    device (the gbm tier's tree tensors and f64 temperature), and its solo
    and grouped packed programs (the host hybrid: its predict function
    and no grouped program)."""

    params: dict[str, torch.Tensor]
    temperature: torch.Tensor
    solo: Callable
    group: Callable
    # Each param's spec over the engine's mesh (empty without one).
    specs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Generation:
    """What one bundle generation serves with: the bundle, its tiers and
    default tier, its monitor state on the device, its row buckets, and on
    the card its CUDA graphs in their pool. Every generation's graphs fold
    into the engine's one accumulator, so a hot swap (``swap_bundle``) is
    one reference exchange and the aggregate never splits."""

    bundle: Bundle
    tiers: dict[str, _Tier]
    default_tier: str
    monitor: MonitorState
    buckets: list[int]
    graphs: dict[tuple, graphs.ServingGraph]
    pool: Any
    # (tier, lead) programs run once off the card-graph route (the CPU,
    # or eager on the card): the shapes this generation has ready there.
    warmed: set = dataclasses.field(default_factory=set)
    # The engine's number for this generation, the same on every rank of
    # a mesh: how an announced operation names it.
    seq: int = 0

    def tier(self, requested: str | None) -> str:
        """The tier a dispatch asking for ``requested`` runs: the default
        for None, or for a tier this generation does not hold (a request
        routed to the quant tier just before a promotion to a bundle
        without one)."""
        return requested if requested in self.tiers else self.default_tier


class _Handle:
    """An in-flight dispatch: the packed output's host buffer, the event
    its copy completes behind (None on the CPU), and the geometry the
    fetch side needs to slice it, and the tier that served it (resolved
    under the lock: the default when the generation lacks the tier asked
    for). A group handle of 1 or more than 64 requests carries their
    already formatted ``responses`` instead (the JAX engine's degenerate
    handle). ``rows``/``slots`` are the geometry that served (a degraded
    fallback's), ``entry`` its label and ``t0`` the cost ledger's
    dispatch stamp (0 with the ledger disarmed)."""

    __slots__ = ("host", "event", "n", "rows", "sizes", "slots", "responses", "tier",
                 "entry", "t0")

    def __init__(self, host=None, event=None, n=0, rows=0, sizes=None,
                 slots=0, responses=None, tier=None, entry=None, t0=0.0):
        self.host = host
        self.event = event
        self.n = n
        self.rows = rows
        self.sizes = sizes
        self.slots = slots
        self.responses = responses
        self.tier = tier
        self.entry = entry
        self.t0 = t0

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class InferenceEngine:
    def __init__(
        self,
        bundle: Bundle,
        buckets: tuple[int, ...] = (1, 8, 64, 256),
        serve_tier: str = "exact",
        device: str | torch.device | None = None,
        tier_routing: bool = False,
        cuda_graphs: bool = True,
        mesh=None,
    ):
        """``cuda_graphs=False`` runs the programs eagerly on the card, for
        holding the graphs against them; nothing in ``serve`` or the CLI
        sets it. ``mesh``, a ``parallel.sharding.ServeMesh``, shards the
        engine over its ranks (``device`` is this rank's: NCCL on the
        card, gloo on the CPU); every rank builds its engines in the same
        order, the lead's announced to the followers."""
        self.device = resolve_device(device)
        # The gbm tier and the host hybrid have no partition rules: they
        # ignore the mesh, as the JAX engine ignores model_shards there.
        self._mesh = mesh if bundle.flavor != "sklearn" else None
        self.model_shards = mesh.size("model") if self._mesh is not None else 1
        if (self._mesh is not None and self.device.type == "cuda"
                and dist_backend(self._mesh) != "nccl"):
            raise ValueError(
                "a sharded engine on the card runs its collectives over NCCL; "
                f"this mesh's group runs {dist_backend(self._mesh)}"
            )
        self._seq = 0
        self.serve_tier = self._resolve_tier(serve_tier, bundle)
        self.tier_routing = bool(tier_routing)
        # The sklearn floor that does not tensorize (rf): its "exact" tier
        # is the host hybrid, which folds no accumulator and has no graphs.
        self._hybrid = bundle.flavor == "sklearn" and self.serve_tier == "exact"
        # Committed once: each tier's params and temperature are
        # arguments of every dispatch and stay on the device.
        tiers = {self.serve_tier: self._build_tier(self.serve_tier, bundle)}
        if self.tier_routing:
            extra = self._extra_tier(bundle)
            if extra is not None:
                tiers[extra] = self._build_tier(extra, bundle)
        # The static accumulator: one f32 buffer rows ‖ outliers ‖ batches
        # ‖ drift_sum[D] ‖ drift_last[D], and the fields as views of it.
        # Every program of every tier and every generation folds into it
        # in place (``_store``); the lock orders the dispatches that do,
        # and on the card holds each one's device work (upload, program or
        # replay, download) on the engine's one stream. The hold is an
        # enqueue, never a wait.
        self._cuda = self.device.type == "cuda"
        self._use_graphs = self._cuda and cuda_graphs and not self._hybrid
        # No other holder's streams (``device.held_stream``): another engine
        # in the process (the lifecycle's shadow engines) never shares them.
        # Captures (and the eager pass before each) run on a stream of their
        # own; the lock and two stream waits order them with the replays on
        # ``_stream`` (``_capture``). The engines of a mesh share both, as
        # they share its lock: their replays run in the announced order.
        self._stream = self._capture_stream = None
        if self._cuda and self._mesh is not None:
            if self._mesh.streams is None:
                self._mesh.streams = (held_stream(self._mesh, self.device),
                                      held_stream(self._mesh, self.device, capture=True))
            self._stream, self._capture_stream = self._mesh.streams
        elif self._cuda:
            self._stream = held_stream(self, self.device)
            if self._use_graphs:
                self._capture_stream = held_stream(self, self.device, capture=True)
        with self._on_stream():
            self._acc_flat = torch.zeros(3 + 2 * _D, dtype=torch.float32,
                                         device=self.device)
        self._acc = _acc_views(self._acc_flat)
        self._acc_lock = self._mesh.lock if self._mesh is not None else threading.Lock()
        self._gen = _Generation(
            bundle=bundle,
            tiers=tiers,
            default_tier=self.serve_tier,
            monitor=bundle.monitor.to(self.device),
            buckets=sorted(buckets),
            graphs={},
            pool=torch.cuda.graph_pool_handle() if self._use_graphs else None,
        )
        # Bundle turnover (``lifecycle/``): the generation counts hot swaps
        # and rollbacks from 1; ``_retired`` is the one-deep history a
        # rollback restores; ``_tee`` is the lifecycle observation hook
        # (``set_lifecycle_tee``).
        self.bundle_generation = 1
        # Grid turnover (``autotune/``): counts the swaps and rollbacks
        # whose generations differ in their bucket lists, from 1; a plain
        # promotion on the same grid leaves it.
        self.grid_generation = 1
        self._retired: _Generation | None = None
        self._tee: Callable[[np.ndarray, np.ndarray], None] | None = None
        self.swap_stats: dict[str, Any] = {}
        self._totals: dict[str, Any] = {
            "rows": 0.0,
            "outliers": 0.0,
            "batches": 0.0,
            "drift_sum": np.zeros(_D, np.float64),
            "drift_last": np.zeros(_D, np.float64),
        }
        self._totals_lock = threading.Lock()
        self._dispatches: dict[str, int] = {}  # entry label -> dispatches
        # Requests served through a larger ready shape after the target
        # shape's capture failed (``_ready_shape``).
        self._degraded = 0
        # Observability hooks, armed by the server: ``set_shape_stats``
        # and ``set_cost_ledger``. None is one branch on the dispatch path.
        self.shape_stats = None
        self.cost_ledger = None
        self._cost_tag = ""
        self._capture_s = 0.0
        self._pool_bytes = 0
        self.warmup_stats: dict[str, Any] = {}
        self.ready = False
        # A follower's generations by number (the live, the retired and a
        # swap's staged one), its scratch accumulator and its unread
        # monitor window (``follow_op``).
        self._gens = {0: self._gen} if mesh is not None and not mesh.lead else {}
        self._scratch = None
        self._window = None
        self._sid = -1
        if self._mesh is not None:
            with self._acc_lock:
                self._sid = self._mesh.built
                self._mesh.built += 1
                self._tell("build", bundle, {
                    "buckets": tuple(buckets), "serve_tier": serve_tier,
                    "tier_routing": tier_routing, "cuda_graphs": cuda_graphs,
                })
            if self._mesh.lead and self._mesh.followers:
                # The followers drop their twin once this engine is gone.
                weakref.finalize(self, self._mesh.dropped.put, self._sid)

    # The serving generation's state, read as the engine's own.
    bundle = property(lambda self: self._gen.bundle)
    default_tier = property(lambda self: self._gen.default_tier)
    buckets = property(lambda self: self._gen.buckets)
    max_bucket = property(lambda self: self._gen.buckets[-1])
    _tiers = property(lambda self: self._gen.tiers)
    _monitor = property(lambda self: self._gen.monitor)
    _graphs = property(lambda self: self._gen.graphs)

    def _resolve_tier(self, serve_tier: str, bundle: Bundle) -> str:
        """The JAX package's tier table: "exact" serves the bundle's exact
        model; "quant" demands a GATED quant tier and raises otherwise (an
        ungraded tier must never serve); "auto" takes the quant tier when
        it is admissible and falls back to exact, logging why. What this
        package cannot serve on either tier is refused with its reason."""
        if serve_tier not in TIER_NAMES:
            raise ValueError(
                f"serve_tier must be 'exact', 'quant' or 'auto', got {serve_tier!r}"
            )
        if serve_tier != "exact":
            why = self._quant_refusal(bundle)
            if not why:
                return "quant"
            if serve_tier == "quant":
                raise ValueError(f"serve_tier='quant' refused: {why}")
            logger.info("serve_tier='auto' falling back to exact tier: %s", why)
        if bundle.flavor == "sklearn":
            # The JAX engine's sklearn branches: a tensorizable HistGBM
            # ensemble serves the gbm tier, any other the host hybrid
            # (whose one tier is named exact, as there).
            return "gbm" if bundle.gbm_tensor is not None else "exact"
        why = ""
        if bundle.flavor != "flax":
            why = f"a {bundle.flavor!r} bundle is scored by predict-file, not served"
        elif bundle.model is None:
            why = bundle.exact_refusal or "bundle carries no exact model"
        if why:
            raise ValueError(f"serve_tier={serve_tier!r} refused: {why}")
        return "exact"

    def _quant_refusal(self, bundle: Bundle) -> str:
        """Why the bundle's quant tier may not serve here ("" when it
        may)."""
        if bundle.flavor == "sklearn":
            return "sklearn bundles have no quant tier"
        if not bundle.has_quant:
            return "bundle carries no quant params"
        if not bundle.quant_gates_passed:
            return (
                "quant tier failed (or was never graded by) the promotion "
                "gates"
            )
        if self.model_shards > 1:
            return (
                "quant tier is single-device; model_shards > 1 shards the "
                "exact params only"
            )
        return ""

    def _extra_tier(self, bundle: Bundle) -> str | None:
        """The tier routing adds (the JAX ``_build_extra_tiers``): an
        exact-default engine adds its gated quant student, when the bundle
        has one; a quant-default engine always keeps its exact teacher,
        and a bundle without one is refused."""
        if bundle.flavor == "sklearn":
            return None  # the gbm tier and the host hybrid stand alone
        if self.serve_tier == "exact":
            return None if self._quant_refusal(bundle) else "quant"
        return self._resolve_tier("exact", bundle)

    def _build_tier(self, tier: str, bundle: Bundle) -> _Tier:
        """``tier``'s params and temperature committed to the device, with
        its programs (``_build_programs``)."""
        if tier == "quant":
            params = {k: v.to(self.device) for k, v in bundle.quant_params.items()}
            temperature = bundle.quant_temperature
        elif tier == "gbm":
            # f64 tree tensors, and a f64 temperature, unlike every other
            # tier's f32: the host hybrid divides logits by the full Python
            # float, and an f32 rounding of T moves about a third of the
            # tempered probabilities by one ulp.
            params = gbm_variables_from_numpy(bundle.gbm_tensor[0], self.device)
            return dataclasses.replace(
                self._build_programs(tier, bundle), params=params,
                temperature=self._scalar(bundle.temperature, torch.float64),
            )
        elif bundle.flavor == "sklearn":
            # The host hybrid: the estimator and the Python temperature on
            # the host, the monitor on the device.
            return _Tier({}, None, make_hybrid_predict_fn(
                bundle.estimator, bundle.monitor.to(self.device), bundle.temperature
            ), None)
        else:
            programs = self._build_programs(tier, bundle)
            params = model_params(bundle.model)
            if self._mesh is not None:
                # This rank's blocks only: each is narrowed on the host
                # before it is committed.
                from mlops_tpu_torch.parallel.sharding import shard_tensor

                params = {k: shard_tensor(v, programs.specs[k], self._mesh)
                          for k, v in params.items()}
            return dataclasses.replace(
                programs, params={k: v.to(self.device) for k, v in params.items()},
                temperature=self._scalar(bundle.temperature),
            )
        return dataclasses.replace(
            self._build_programs(tier, bundle),
            params=params, temperature=self._scalar(temperature),
        )

    def _build_programs(self, tier: str, bundle: Bundle) -> _Tier:
        """``tier``'s solo and grouped programs, params not yet set. The
        exact tier's apply its params to a module (which has no buffers)
        by swapping them in for the call, under the engine lock; the
        engine's own copy of the module keeps another engine over the same
        bundle out of the swap. Over a mesh, the copy is laid out for this
        rank (``shard_model``: its layers' splits and collectives), and
        the tier records each param's spec."""
        if tier == "quant":
            return _Tier({}, None, make_quant_packed_base(), make_quant_grouped_base())
        if tier == "gbm":
            depth = bundle.gbm_tensor[1].depth
            return _Tier({}, None, make_gbm_packed_base(depth), make_gbm_grouped_base(depth))
        model = copy.deepcopy(bundle.model).eval()
        specs = {}
        if self._mesh is not None:
            from mlops_tpu_torch.parallel.steps import layout_specs, shard_model

            specs = layout_specs(model, self._mesh)
            shard_model(model, self._mesh, specs)
        return _Tier(
            {}, None, make_packed_predict_base(model), make_packed_grouped_base(model),
            specs,
        )

    def _scalar(self, value: float, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    @property
    def supports_grouping(self) -> bool:
        """The grouped path exists on every tier but the host hybrid."""
        return not self._hybrid

    @property
    def gbm_geometry(self):
        """The serving gbm tier's ``GbmGeometry`` (None on other tiers)."""
        gen = self._gen
        return gen.bundle.gbm_tensor[1] if gen.default_tier == "gbm" else None

    @property
    def available_tiers(self) -> tuple[str, ...]:
        """The tiers this engine dispatches per request, cheapest -> most
        accurate (``tierroute.TIERS`` order); one tier without routing."""
        return tuple(t for t in TIERS if t in self._tiers)

    def route_tier(self, slo_class: int) -> str | None:
        """SLO class -> the tier that serves it here; None means the
        default tier."""
        tier = tier_for_class(self.available_tiers, self.default_tier, slo_class)
        return None if tier == self.default_tier else tier

    @property
    def monitor_accumulating(self) -> bool:
        """The programs fold their monitor statistics into the device
        accumulator (every tier but the host hybrid, whose monitor totals
        the server folds on the host): what a hot swap needs on both
        sides."""
        return not self._hybrid

    def _normalize_tier(self, tier: str | None) -> str | None:
        """None and the default tier both mean the default tier (None);
        any other must be held by this engine's serving or retired
        generation (routing never invents a tier). A tier only the retired
        one holds serves on the default tier (``_Generation.tier``)."""
        if tier is None or tier == self.default_tier:
            return None
        retired = self._retired
        if tier not in self._tiers and (retired is None or tier not in retired.tiers):
            raise ValueError(
                f"tier {tier!r} is not committed on this engine "
                f"(available: {self.available_tiers})"
            )
        return tier

    # ------------------------------------------------------------- warmup
    @staticmethod
    def _warm_keys(gen: _Generation) -> list[tuple]:
        """Every (tier, padded shape) the server dispatches for ``gen``:
        each tier's row buckets and its group geometries."""
        group = [(s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS]
        return [
            (tier, lead)
            for tier in gen.tiers
            for lead in [(b,) for b in gen.buckets] + group
        ]

    def warmup(self) -> None:
        """Ready every bucket and group geometry of every tier before
        traffic, without touching the live monitor aggregate. On the CPU
        each program runs once on zeros against a scratch accumulator. On
        the card each is also captured into its CUDA graph (after one such
        eager pass on the engine's stream); a capture that fails raises."""
        t0 = time.perf_counter()
        if self._hybrid:
            self._warm_hybrid(t0)
            return
        keys = self._warm_keys(self._gen)
        self._ready_keys(self._gen, keys)
        self.warmup_stats = {
            "warmup_s": round(time.perf_counter() - t0, 3),
            "programs": len(keys),
            "device": str(self.device),
            "tier": self.serve_tier,
            "tiers": list(self.available_tiers),
            "route": "cuda_graphs" if self._use_graphs else "eager",
        }
        if self._use_graphs:
            self.warmup_stats.update(
                capture_s=round(self._capture_s, 3),
                graph_pool_bytes=self._pool_bytes,
            )
        self.ready = True

    def _warm_hybrid(self, t0: float) -> None:
        """The host hybrid's warmup, as the JAX engine's: each bucket runs
        once on zeros (its monitors' first kernels and allocations); there
        is nothing to capture."""
        predict = self._gen.tiers[self.serve_tier].solo
        for bucket in self.buckets:
            predict(*_host_batch((bucket,))[:2], np.ones(bucket, bool))
        self.warmup_stats = {
            "warmup_s": round(time.perf_counter() - t0, 3),
            "programs": len(self.buckets),
            "device": str(self.device),
            "tier": self.serve_tier,
            "tiers": list(self.available_tiers),
            "route": "host_hybrid",
        }
        self.ready = True

    def _ready_keys(self, gen: _Generation, keys) -> int:
        """Ready each ``(tier, lead)`` of ``keys`` that ``gen`` lacks, one
        per lock hold, so dispatches go on between them: on the card its
        capture into ``gen``'s graphs (``_capture``), on the eager route
        one run on zeros against a scratch accumulator. Returns how many
        were readied."""
        ready = gen.graphs if self._use_graphs else gen.warmed
        scratch = None
        if not self._use_graphs:
            with self._on_stream():
                scratch = init_accumulator(self.device)
        readied = 0
        for tier, lead in keys:
            with self._acc_lock:
                if (tier, lead) in ready:
                    continue
                self._tell("ready", gen.seq, tier, lead, True)
                self._ready_one(gen, tier, lead, scratch)
                readied += 1
        if scratch is not None:
            scratch.rows.cpu()  # waits for every warm launch to finish
        return readied

    def _ready_one(self, gen: _Generation, tier: str, lead: tuple[int, ...],
                   scratch, run: bool = True) -> None:
        """Ready one shape of ``gen`` (caller holds the lock): its capture
        on the card; on the eager route one run on zeros against
        ``scratch`` (with ``run``), or none (its first run is a dispatch).
        Raises what failed, and stores nothing then.

        On a mesh with followers every rank readies the shape, and the
        ranks agree on the outcome before it counts as ready on any
        (``ServeMesh.agree``): a shape that failed on one rank is ready on
        none, and the lead raises. Ranks that ran different numbers of
        eager collectives meanwhile (one failed between two of the warm
        pass's) leave the mesh out of step: that raises ``MeshOutOfStep``
        on every rank. A rank still waiting in a collective its peer never
        joins is ended by the group's timeout; either way the followers
        exit and the replica restarts (``serve/shards.py``)."""
        issued = COLLECTIVE_CALLS.value
        failed = captured = None
        try:
            if self._use_graphs:
                captured = self._capture(gen, tier, lead)
            elif run:
                with self._on_stream():
                    self._warm_pass(gen, tier, lead, scratch)
        except Exception as err:
            failed = err
        if self._mesh is not None:
            issued = COLLECTIVE_CALLS.value - issued
            if not self._mesh.agree(failed is None, issued) and failed is None:
                failed = RuntimeError(
                    f"readying {tier} {lead} failed on another rank of the mesh")
        if failed is not None:
            raise failed
        if captured is None:
            gen.warmed.add((tier, lead))
            return
        graph, seconds, grown = captured
        self._capture_s += seconds
        self._pool_bytes += grown
        gen.graphs[(tier, lead)] = graph

    def _warm_pass(self, gen: _Generation, tier: str, lead: tuple[int, ...],
                   scratch) -> None:
        """One eager run of a program on zeros (every row valid) against
        ``scratch``, on the current stream (caller holds the lock)."""
        cat = torch.zeros((*lead, SCHEMA.num_categorical), dtype=torch.int32,
                          device=self.device)
        num = torch.zeros((*lead, SCHEMA.num_numeric), dtype=torch.float32,
                          device=self.device)
        mask = torch.ones(lead, dtype=torch.bool, device=self.device)
        self._run(gen, tier, lead, scratch, cat, num, mask)

    def _capture(self, gen: _Generation, tier: str, lead: tuple[int, ...]):
        """One eager pass of ``gen``'s program against a scratch
        accumulator, then its capture over the engine's accumulator into
        ``gen``'s pool, both on the capture stream (caller holds the
        lock); returns the graph, the capture's seconds and the bytes the
        pool grew by, for ``_ready_one`` to store. The capture stream first waits for every replay already
        enqueued, and later replays wait for the eager pass: the two never
        overlap on the device, so they may share cuBLAS's workspace."""
        side = self._capture_stream
        side.wait_stream(self._stream)

        def run(cat, num, mask):
            out, new_acc = self._run(gen, tier, lead, self._acc, cat, num, mask)
            self._store(new_acc)
            return out

        try:
            with torch.cuda.stream(side):
                self._warm_pass(gen, tier, lead, init_accumulator(self.device))
            graph, seconds, grown = graphs.capture(
                run, lead, self.device, side, gen.pool,
                replays=gbm_graph_replays if tier == "gbm" else None,
            )
        finally:
            # Also after a failed capture: whatever the side stream ran
            # is ordered before the next replay, and no graph is stored.
            self._stream.wait_stream(side)
        if (self._mesh is not None and graph.collectives == 0
                and any(sharded_axes(spec) for spec in gen.tiers[tier].specs.values())):
            # No fallback: a sharded program whose collectives did not reach
            # the graph would answer with one rank's partial sums.
            raise RuntimeError(
                f"the {tier} graph at {lead} captured no collective over the mesh"
            )
        return graph, seconds, grown

    # ----------------------------------------------------------- dispatch
    def _on_stream(self):
        if self._cuda:
            return torch.cuda.stream(self._stream)
        return contextlib.nullcontext()

    def _run(self, gen: _Generation, tier: str, lead: tuple[int, ...], acc,
             *batch):
        """One packed program of ``gen``'s ``tier`` on its committed state
        (no autograd): solo for a ``(rows,)`` batch, grouped for
        ``(slots, rows)``."""
        state = gen.tiers[tier]
        program = state.solo if len(lead) == 1 else state.group
        with torch.inference_mode():
            return program(
                state.params, gen.monitor, acc, state.temperature, *batch
            )

    def _store(self, new: MonitorAccumulator) -> None:
        """Write a program's folded accumulator into the static one."""
        torch.cat(
            [new.rows.reshape(1), new.outliers.reshape(1),
             new.batches.reshape(1), new.drift_sum, new.drift_last],
            out=self._acc_flat,
        )

    def _dispatch(
        self, tier: str | None, lead: tuple[int, ...], requested: int,
        need: tuple[int, ...],
        fill: Callable[[np.ndarray, np.ndarray, np.ndarray], None],
    ) -> tuple[Any, Any, str, tuple[int, ...], str, float]:
        """Run one packed program on a batch that ``fill(cat, num, mask)``
        writes into zeroed host arrays of shape ``lead``, fold the
        accumulator and start the packed buffer's copy to the host. The
        generation, and in it the tier (``_Generation.tier``), is read
        under the lock: a dispatch runs exactly one generation.

        On the card the batch is written straight into a pinned buffer;
        under the lock, on the engine's stream, it is uploaded into the
        graph's static inputs with one copy, the graph replays, and its
        static output is copied into this dispatch's own pinned buffer
        behind an event. Only the event wait (``fetch``) is outside. A
        shape that is not ready yet is readied under the lock first, or
        served through a larger ready one (``_ready_shape``; ``need`` is
        the least geometry that holds the batch). Returns the host buffer,
        its event, the tier and the geometry that served, the entry label
        and the cost ledger's dispatch stamp (0 when it is disarmed)."""
        t0 = time.perf_counter() if self.cost_ledger is not None else 0.0
        if not self._cuda:
            batch = _host_batch(lead)
            fill(*batch)
            with self._acc_lock:
                gen = self._gen
                tier = gen.tier(tier)
                served = self._ready_shape(gen, tier, lead, need)
                if served != lead:
                    batch = _host_batch(served)
                    fill(*batch)
                self._tell("run", gen.seq, tier, served, batch)
                host = self._launch(gen, tier, served, batch)
            event = None
        else:
            staged = torch.zeros(graphs.input_nbytes(lead), dtype=torch.uint8,
                                 pin_memory=True)
            fill(*graphs.split_host(staged.numpy(), lead))
            with self._acc_lock, self._on_stream():
                gen = self._gen
                tier = gen.tier(tier)
                served = self._ready_shape(gen, tier, lead, need)
                if served != lead:
                    staged = torch.zeros(graphs.input_nbytes(served),
                                         dtype=torch.uint8, pin_memory=True)
                    fill(*graphs.split_host(staged.numpy(), served))
                self._tell("run", gen.seq, tier, served, staged.numpy())
                out = self._launch(gen, tier, served, staged)
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        base = (f"bucket_{served[0]}" if len(served) == 1
                else f"group_{served[0]}x{served[1]}")
        label = _entry_name(base, tier, gen)
        self._count(label)
        stats = self.shape_stats
        if stats is not None:
            # The shape that served, a degraded fallback's included: the
            # histogram describes the compute paid, not the compute meant.
            stats.observe(label, requested, int(np.prod(served)))
        return host, event, tier, served, label, t0

    def _launch(self, gen: _Generation, tier: str, served: tuple[int, ...], batch):
        """The device work of one dispatch of ``served`` rows (caller holds
        the lock; on the card, on the engine's stream): on the CPU
        ``batch`` is the host arrays, run and folded; on the card it is
        the pinned packed buffer, uploaded into the graph's static inputs
        with one copy and replayed (eagerly: uploaded and run). Returns
        the packed output on the device."""
        if not self._cuda:
            out, new_acc = self._run(gen, tier, served, self._acc,
                                     *map(torch.from_numpy, batch))
            self._store(new_acc)
            return out
        if self._use_graphs:
            graph = gen.graphs[(tier, served)]
            graph.inputs.copy_(batch, non_blocking=True)
            graph.replay()
            return graph.out
        inputs = batch.to(self.device, non_blocking=True)
        out, new_acc = self._run(gen, tier, served, self._acc,
                                 *graphs.split_inputs(inputs, served))
        self._store(new_acc)
        return out

    def _ready_shape(self, gen: _Generation, tier: str, lead: tuple[int, ...],
                     need: tuple[int, ...]) -> tuple[int, ...]:
        """The geometry a dispatch of ``lead`` serves through (caller holds
        the lock). A shape warmup readied is itself. Any other is readied
        now, at the ``serve.engine.compile`` fault point: captured into
        its graph on the card, on the eager route simply marked ready (its
        first run is the dispatch). When that fails, the dispatch degrades
        to the smallest ready shape of the same tier and kind that holds
        ``need`` (every axis at least as large; a tie goes to the earlier
        warm key), padding masked out of every statistic, and the request
        is counted in ``degraded_dispatch_total``; with none, the failure
        raises. A failed capture stores no graph."""
        ready = gen.graphs if self._use_graphs else gen.warmed
        key = (tier, lead)
        if key in ready:
            return lead
        try:
            # Fault point (raise = a failed capture of a shape warmup did
            # not cover -> the degraded fallback below).
            faults.fire("serve.engine.compile")
            self._tell("ready", gen.seq, tier, lead, False)
            self._ready_one(gen, tier, lead, None, run=False)
            return lead
        except Exception:
            fits = [
                cand for t, cand in self._warm_keys(gen)
                if t == tier and (t, cand) in ready and len(cand) == len(lead)
                and cand != lead and all(c >= n for c, n in zip(cand, need))
            ]
            if not fits:
                raise
            fallback = min(fits, key=lambda cand: int(np.prod(cand)))
            logger.warning(
                "dispatch at %s failed; degrading to ready shape %s",
                lead, fallback, exc_info=True,
            )
            with self._totals_lock:
                self._degraded += 1
            return fallback

    @property
    def degraded_dispatch_total(self) -> int:
        """Requests served through a degraded (larger than their target)
        shape: the ``mlops_tpu_degraded_dispatch_total`` counter."""
        with self._totals_lock:
            return self._degraded

    def set_shape_stats(self, stats) -> None:
        """Install (or clear, with None) the shape histograms: a
        ``trace.shapes.ShapeStats`` fed (entry, requested rows, padded
        rows) per dispatch, called bare on the dispatch path."""
        self.shape_stats = stats

    def set_cost_ledger(self, ledger) -> None:
        """Install (or clear, with None) the device-time cost ledger
        (``slo.ledger.CostLedger``): every dispatch bills (entry,
        requested rows, padded rows, dispatch -> fetch seconds) under
        ``<entry>@<model tag>``. Disarmed it is one branch on the
        dispatch path and one on the fetch path."""
        if ledger is not None:
            self._cost_tag = model_tag(self.bundle.model_config)
        self.cost_ledger = ledger

    def _bill(self, handle: _Handle, requested: int) -> None:
        """The fetch side's ledger hook: the packed buffer is in hand, so
        the seconds since the dispatch stamp are the device path's."""
        ledger = self.cost_ledger
        if ledger is not None and handle.t0:
            padded = handle.rows * (handle.slots or 1)
            ledger.observe(handle.entry, self._cost_tag, requested, padded,
                           time.perf_counter() - handle.t0)

    def _count(self, entry: str) -> None:
        with self._totals_lock:
            self._dispatches[entry] = self._dispatches.get(entry, 0) + 1

    def dispatch_counts(self) -> dict[str, int]:
        """Dispatches per entry label (``bucket_<rows>``,
        ``group_<slots>x<rows>``, ``@<tier>`` for a non-default tier); on
        the card each is one graph replay."""
        with self._totals_lock:
            return dict(self._dispatches)

    def _bucket_for(self, n: int) -> int | None:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[i] if i < len(self.buckets) else None

    def dispatch_arrays(
        self, cat_ids: np.ndarray, numeric: np.ndarray, tier: str | None = None
    ) -> _Handle | None:
        """Pad to the bucket and enqueue the fused dispatch without
        waiting for it; None for the empty request (no device work)."""
        tier = self._normalize_tier(tier)
        n = cat_ids.shape[0]
        if n == 0:
            return None
        tee = self._tee
        if tee is not None:
            # Lifecycle observation (the reservoir and the shadow mirror):
            # the pre-padding arrays, into a bounded non-blocking queue.
            tee(cat_ids, numeric)
        # Fault point (raise = device error -> 500; delay = engine stall
        # -> deadline 504), fired on the host outside every lock: before
        # the graph replay, never inside a capture, where it would run
        # once at capture time.
        faults.fire("serve.engine.dispatch")
        bucket = self._bucket_for(n)
        rows = bucket if bucket is not None else n

        def fill(cat, num, mask):
            cat[:n] = cat_ids
            num[:n] = numeric
            mask[:n] = True

        if self._hybrid:
            return self._dispatch_hybrid(n, rows, fill)
        host, event, served, lead, entry, t0 = self._dispatch(
            tier, (rows,), n, (n,), fill)
        return _Handle(host, event, n=n, rows=lead[0], tier=served, entry=entry, t0=t0)

    def _dispatch_hybrid(self, n: int, rows: int, fill) -> _Handle:
        """The host hybrid's dispatch (the JAX engine's dict route): the
        padded batch through ``make_hybrid_predict_fn``, its outputs laid
        out as the packed buffer so the fetch side is every tier's. No
        lock: nothing here is shared state."""
        batch = _host_batch((rows,))
        fill(*batch)
        out = self._gen.tiers[self.serve_tier].solo(*batch)
        host = torch.from_numpy(np.concatenate([
            out["predictions"],
            out["outliers"].float().cpu().numpy(),
            out["feature_drift_batch"].float().cpu().numpy(),
        ]))
        label = f"bucket_{rows}"
        self._count(label)
        stats = self.shape_stats
        if stats is not None:
            stats.observe(label, n, rows)
        return _Handle(host, None, n=n, rows=rows, tier=self.serve_tier, entry=label)

    def fetch_arrays_raw(
        self, handle: _Handle
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for the packed buffer: ``(predictions f64[n], outliers
        f64[n], drift f64[D] rounded to 6 places)``."""
        arr = handle.wait()
        self._bill(handle, handle.n)
        p, o, d = packed_layout(handle.rows)
        return (
            arr[p][: handle.n].astype(float),
            arr[o][: handle.n].astype(float),
            arr[d].astype(float).round(6),
        )

    def fetch_arrays(self, handle: _Handle) -> dict[str, Any]:
        return format_response(*self.fetch_arrays_raw(handle))

    def fetch_arrays_wire(self, handle: _Handle) -> bytes:
        return encode_response(*self.fetch_arrays_raw(handle))

    def predict_arrays(
        self, cat_ids: np.ndarray, numeric: np.ndarray, span=None,
        tier: str | None = None,
    ) -> dict[str, Any]:
        """``span`` (``trace.Span``, tracing armed) gets the ``dispatch``
        stamp once the replay and the copy to the host are enqueued and
        ``device_fetch`` once the host buffer is complete."""
        handle = self.dispatch_arrays(cat_ids, numeric, tier=tier)
        if handle is None:
            return empty_response()
        if span is not None:
            span.stamp("dispatch")
            span.entry = handle.entry
        response = self.fetch_arrays(handle)
        if span is not None:
            span.stamp("device_fetch")
        return response

    def predict_records(
        self, records: list[dict[str, Any]], span=None, tier: str | None = None
    ) -> dict[str, Any]:
        """Validated records -> the reference response dict; ``span`` gets
        the engine-side stamps (``encode``, then ``predict_arrays``')."""
        ds = self.bundle.preprocessor.encode(records_to_columns(records))
        if span is not None:
            span.stamp("encode")
        return self.predict_arrays(ds.cat_ids, ds.numeric, span=span, tier=tier)

    def predict_records_wire(
        self, records: list[dict[str, Any]], span=None, tier: str | None = None
    ) -> bytes:
        """Validated records -> response wire bytes, encoded in the calling
        (executor) thread; ``span`` as in ``predict_records``."""
        ds = self.bundle.preprocessor.encode(records_to_columns(records))
        if span is not None:
            span.stamp("encode")
        handle = self.dispatch_arrays(ds.cat_ids, ds.numeric, tier=tier)
        if handle is None:
            return EMPTY_RESPONSE_BYTES
        if span is not None:
            span.stamp("dispatch")
            span.entry = handle.entry
        response = self.fetch_arrays_wire(handle)
        if span is not None:
            span.stamp("device_fetch")
        return response

    # ----------------------------------------------------- grouped predict
    def predict_group(
        self, requests: list[list[dict[str, Any]]], tier: str | None = None
    ) -> list[dict[str, Any]]:
        """Score several concurrent requests in one dispatch; each response
        is what ``predict_records`` gives that request alone."""
        return self.fetch_group(self.dispatch_group(requests, tier=tier))

    def dispatch_group(
        self, requests: list[list[dict[str, Any]]], tier: str | None = None
    ) -> _Handle:
        """Encode the group in one pass, split it back per request and
        enqueue the grouped dispatch without waiting (the micro-batcher
        dispatches the next group while this one's copy lands). One
        request, or more than 64, score solo into a handle that carries
        their responses."""
        if len(requests) == 1 or len(requests) > GROUP_SLOT_BUCKETS[-1]:
            return _Handle(
                responses=[self.predict_records(r, tier=tier) for r in requests]
            )
        sizes = [len(r) for r in requests]
        if not all(1 <= n <= GROUP_ROW_BUCKET for n in sizes):
            raise ValueError(
                f"grouped requests must have 1..{GROUP_ROW_BUCKET} records, "
                f"got sizes {sizes}"
            )
        # Encoding is row-wise, so one flat encode equals per-request
        # encodes and does the Python work once.
        flat = [record for records in requests for record in records]
        ds = self.bundle.preprocessor.encode(records_to_columns(flat))
        bounds = np.cumsum([0, *sizes])
        parts = [
            (ds.cat_ids[lo:hi], ds.numeric[lo:hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])
        ]
        return self.dispatch_group_arrays(parts, tier=tier)

    def dispatch_group_arrays(
        self, parts: list[tuple[np.ndarray, np.ndarray]], tier: str | None = None
    ) -> _Handle:
        """One dispatch for 2..64 pre-encoded requests of 1..8 rows each:
        slots pad to a slot bucket, rows to 1 (all batch-1) or 8, and
        every slot's drift is computed over its own rows. The whole group
        runs one tier."""
        if self._hybrid:
            raise ValueError("the host-hybrid flavor (rf) has no grouped path")
        tier = self._normalize_tier(tier)
        sizes = [cat.shape[0] for cat, _ in parts]
        tee = self._tee
        if tee is not None:
            for part_cat, part_num in parts:
                tee(part_cat, part_num)
        if not 2 <= len(parts) <= GROUP_SLOT_BUCKETS[-1]:
            raise ValueError(
                f"grouped dispatch takes 2..{GROUP_SLOT_BUCKETS[-1]} "
                f"requests, got {len(parts)}"
            )
        if not all(1 <= n <= GROUP_ROW_BUCKET for n in sizes):
            raise ValueError(
                f"grouped requests must have 1..{GROUP_ROW_BUCKET} records, "
                f"got sizes {sizes}"
            )
        # Fault point: the grouped twin of ``serve.engine.dispatch`` (the
        # micro-batcher's and the ring plane's coalesced jobs).
        faults.fire("serve.engine.dispatch_group")
        slots = GROUP_SLOT_BUCKETS[
            bisect.bisect_left(GROUP_SLOT_BUCKETS, len(parts))
        ]
        rows = GROUP_ROW_BUCKETS[0] if max(sizes) == 1 else GROUP_ROW_BUCKET

        def fill(cat, num, mask):
            for i, (part_cat, part_num) in enumerate(parts):
                n = sizes[i]
                cat[i, :n] = part_cat
                num[i, :n] = part_num
                mask[i, :n] = True

        host, event, served, lead, entry, t0 = self._dispatch(
            tier, (slots, rows), sum(sizes), (len(parts), max(sizes)), fill
        )
        return _Handle(host, event, rows=lead[1], sizes=sizes, slots=lead[0],
                       tier=served, entry=entry, t0=t0)

    def fetch_group_raw(
        self, handle: _Handle
    ) -> tuple[list[int], np.ndarray, np.ndarray, np.ndarray]:
        """``(sizes, predictions f64[slots, rows], outliers f64[slots,
        rows], drift f64[slots, D] rounded)``."""
        if handle.responses is not None:
            raise ValueError("degenerate group handle carries formatted "
                             "responses; fetch_group owns that path")
        arr = handle.wait()
        self._bill(handle, sum(handle.sizes))
        p, o, d = packed_layout(handle.rows)
        return (
            handle.sizes,
            arr[:, p].astype(float),
            arr[:, o].astype(float),
            arr[:, d].astype(float).round(6),
        )

    def fetch_group(self, handle: _Handle) -> list[dict[str, Any]]:
        if handle.responses is not None:
            return handle.responses
        sizes, preds, outs, drifts = self.fetch_group_raw(handle)
        return [
            format_response(preds[i, :n], outs[i, :n], drifts[i])
            for i, n in enumerate(sizes)
        ]

    def fetch_group_wire(self, handle: _Handle) -> list[bytes]:
        """``fetch_group`` straight to per-request wire bytes."""
        if handle.responses is not None:
            return [
                json.dumps(r, separators=(",", ":")).encode()
                for r in handle.responses
            ]
        sizes, preds, outs, drifts = self.fetch_group_raw(handle)
        return [
            encode_response(preds[i, :n], outs[i, :n], drifts[i])
            for i, n in enumerate(sizes)
        ]

    # ----------------------------------------------------- bundle turnover
    def set_lifecycle_tee(
        self, tee: Callable[[np.ndarray, np.ndarray], None] | None
    ) -> None:
        """Install (or clear, with None) the lifecycle observation hook:
        ``tee(cat_ids, numeric)`` is called with each request's
        pre-padding encoded arrays on the dispatch path. The tee owns its
        cheapness and safety (a bounded non-blocking enqueue that never
        raises); the engine calls it bare."""
        self._tee = tee

    def swap_bundle(self, candidate: "InferenceEngine") -> int:
        """Hot-promote a candidate engine's bundle in place with zero
        downtime; returns the new generation.

        The candidate's graphs fold into the candidate's own accumulator,
        so they are not what this engine serves: first, outside the swap,
        each of the candidate's programs is captured again over this
        engine's accumulator into a pool of its own, one graph per lock
        hold on this engine's capture stream, as a shape warmup did not
        cover is (on the CPU the programs run eagerly and nothing is
        captured). The swap itself is then one exchange of generations
        under the lock, with no capture and no transfer: every dispatch
        reads its generation under the same lock, so each runs exactly
        one, and every served row folds into the one aggregate exactly
        once across the swap. The outgoing generation, graphs and pool
        included, is kept for ``rollback``. The candidate engine is not
        used by this engine afterwards: it shares its param tensors only.

        Refused as the JAX engine refuses: engines that do not both
        accumulate, a candidate without the grouped path, and one whose
        largest bucket is smaller (the server caps requests at it). A
        sharded engine takes a candidate built over its own mesh (its
        params are this rank's blocks, and every rank holds its twin)."""
        if not self.monitor_accumulating or not getattr(
            candidate, "monitor_accumulating", False
        ):
            raise ValueError(
                "hot swap requires device-accumulating engines on both "
                "sides — the host-hybrid flavor (rf) redeploys instead"
            )
        if self.supports_grouping and not candidate.supports_grouping:
            raise ValueError(
                "candidate engine lacks the grouped path the live engine "
                "serves — build it with enable_grouping=True"
            )
        self._check_ceiling(candidate.buckets)
        if getattr(candidate, "_mesh", None) is not self._mesh:
            raise ValueError(
                "a sharded engine swaps in a candidate built over the same "
                "mesh (and an unsharded one an unsharded candidate)"
            )
        staged = self._stage(candidate)
        with self._acc_lock:
            self._tell("stage", candidate._sid, staged.seq)
        t0 = time.perf_counter()
        pool_before = self._pool_bytes
        if self._use_graphs:
            self._ready_keys(staged, self._warm_keys(staged))
        self._exchange(staged, "swap", graphs=len(staged.graphs),
                       capture_s=round(time.perf_counter() - t0, 6),
                       graph_pool_bytes=self._pool_bytes - pool_before)
        return self.bundle_generation

    def _stage(self, candidate: "InferenceEngine", seq: int | None = None) -> _Generation:
        """A generation serving the candidate's bundle with its committed
        params, under this engine's programs, graphs to be captured (a
        follower builds the same from its twin of the candidate, under the
        lead's number ``seq``)."""
        if seq is None:
            seq = self._next_seq()
        self._seq = seq
        source = candidate._gen
        return _Generation(
            bundle=source.bundle,
            tiers={
                name: dataclasses.replace(
                    self._build_programs(name, source.bundle),
                    params=tier.params, temperature=tier.temperature,
                )
                for name, tier in source.tiers.items()
            },
            default_tier=source.default_tier,
            monitor=source.monitor,
            buckets=list(source.buckets),
            graphs={},
            pool=torch.cuda.graph_pool_handle() if self._use_graphs else None,
            # The eager route runs the candidate's programs as they are:
            # the shapes it readied stay ready.
            warmed=set(source.warmed),
            seq=seq,
        )

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def rollback(self) -> int:
        """Restore the retired generation in one exchange under the lock
        (graphs, tiers and pool included: nothing is captured). The
        generations exchange, so a rollback can itself be rolled back.
        Raises if no swap ever happened."""
        if self._retired is None:
            raise ValueError("no retired bundle to roll back to")
        self._exchange(None, "rollback")
        return self.bundle_generation

    def _exchange(self, staged: _Generation | None, op: str,
                  expect: _Generation | None = None, **stats) -> None:
        """Serve ``staged`` (None: the retired generation) from now on, in
        one reference exchange under the lock with no capture and no
        transfer; the outgoing generation is kept for ``rollback``. Every
        dispatch reads its generation under the same lock, so each runs
        exactly one. ``bundle_generation`` moves, and ``grid_generation``
        when the bucket lists differ. With ``expect``, refuses when another
        exchange came after ``expect`` was read. ``swap_stats`` records
        ``op``, ``stats`` and the exchange's time under the lock."""
        with self._acc_lock:
            t1 = time.perf_counter()
            if expect is not None and self._gen is not expect:
                raise ValueError("the serving generation changed during the regrid")
            self._tell("exchange", None if staged is None else staged.seq, op,
                       staged.buckets if op == "regrid" else None)
            incoming = self._retired if staged is None else staged
            regrid = incoming.buckets != self._gen.buckets
            self._retired, self._gen = self._gen, incoming
            self.bundle_generation += 1
            if regrid:
                self.grid_generation += 1
            critical = time.perf_counter() - t1
        if self.cost_ledger is not None:
            # Bill the serving architecture from here on (outside the lock;
            # a dispatch already in flight bills the outgoing tag).
            self._cost_tag = model_tag(self.bundle.model_config)
        self.swap_stats = {
            "op": op,
            "generation": self.bundle_generation,
            "grid_generation": self.grid_generation,
            **stats,
            "critical_us": round(critical * 1e6, 3),
        }

    # ------------------------------------------------------- grid turnover
    def _check_ceiling(self, buckets: list[int]) -> None:
        """The JAX engine's floor: the front ends clamp requests at the
        largest bucket at start, so a grid may never lower it."""
        if buckets[-1] < self.max_bucket:
            raise ValueError(
                f"candidate max_bucket {buckets[-1]} < live "
                f"{self.max_bucket}: a swap may never shrink shape "
                "coverage below the admission ceiling"
            )

    @staticmethod
    def _grid_keys(gen: _Generation, buckets: list[int]) -> list[tuple]:
        """Every (tier, (bucket,)) a generation serving ``buckets``
        dispatches solo: each bucket on each tier ``gen`` holds."""
        return [(tier, (b,)) for tier in gen.tiers for b in buckets]

    def warm_grid(self, buckets) -> dict[str, Any]:
        """Ready the solo programs a grid of ``buckets`` needs and the
        serving generation lacks, on every tier it holds, off the request
        path (``_ready_keys``: on the card one capture into the
        generation's pool per lock hold while the other graphs keep
        replaying). A crash midway leaves only extra ready shapes behind.
        Returns what ``regrid`` records: ``graphs`` readied (0: the
        generation already covers the grid), ``capture_s`` and
        ``graph_pool_bytes``. Refuses a grid whose largest bucket is below
        the live one."""
        buckets = sorted({int(b) for b in buckets})
        if self._hybrid:
            raise ValueError("the host-hybrid flavor (rf) has no compiled "
                             "programs to regrid")
        self._check_ceiling(buckets)
        gen = self._gen
        t0 = time.perf_counter()
        pool_before = self._pool_bytes
        readied = self._ready_keys(gen, self._grid_keys(gen, buckets))
        return {
            "graphs": readied,
            "capture_s": round(time.perf_counter() - t0, 6),
            "graph_pool_bytes": self._pool_bytes - pool_before,
        }

    def regrid(self, buckets, warm: dict[str, Any] | None = None) -> int:
        """Serve ``buckets`` from now on; returns the new
        ``grid_generation``. The incoming generation keeps the serving
        one's bundle, tiers (params by reference), monitor and pool and
        shares its graphs dict (on the eager route its ready set) by
        reference, so it holds every shape the outgoing one did: a
        dispatch that chose its bucket from the old grid just before the
        exchange replays an existing graph, never a capture, and a
        rollback is warm. The exchange is ``_exchange``'s; ``warm`` is
        ``warm_grid``'s record of the captures, kept in ``swap_stats``, and
        ``bundle_generation`` moves too, as a JAX regrid is a swap. Raises
        when the grid lowers the ceiling or ``warm_grid`` has not readied
        every shape it needs (then nothing is exchanged)."""
        buckets = sorted({int(b) for b in buckets})
        self._check_ceiling(buckets)
        # Built outside the lock: a generation's ready shapes only grow, so
        # what is ready now is ready at the exchange, and the exchange
        # checks that no other swap came between.
        live = self._gen
        ready = live.graphs if self._use_graphs else live.warmed
        missing = [k for k in self._grid_keys(live, buckets) if k not in ready]
        if missing:
            raise ValueError(f"regrid to {buckets}: {missing} not ready; warm_grid first")
        self._exchange(dataclasses.replace(live, buckets=buckets, seq=self._next_seq()),
                       "regrid", expect=live,
                       buckets=buckets, **{"graphs": 0, "capture_s": 0.0,
                                           "graph_pool_bytes": 0, **(warm or {})})
        return self.grid_generation

    # ------------------------------------------------------------ monitor
    def monitor_snapshot(self) -> dict[str, Any]:
        """ONE device -> host read of the monitor aggregate, off the
        request path. Fetch-and-reset: under the lock the static
        accumulator is cloned and zeroed in place, and the fetched window
        folds into exact f64 host totals, so the f32 device counters never
        approach 2^24. A window whose fetch fails folds back into the live
        accumulator: the counts are delayed, never dropped. The host hybrid
        has no accumulator: ``{}``, as the JAX engine returns."""
        if self._hybrid:
            return {}
        with self._acc_lock, self._on_stream():
            self._tell("snapshot")
            window = self._acc_flat.clone()
            self._acc_flat.zero_()
            if self._cuda:
                host = torch.empty(window.shape, dtype=window.dtype,
                                   pin_memory=True)
                host.copy_(window, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        try:
            if self._cuda:
                event.synchronize()
            else:
                host = window
            flat = host.double().numpy()
        except Exception:
            with self._acc_lock, self._on_stream():
                self._tell("fold_back")
                self._fold_back(window)
            raise
        rows, outliers, window_batches = (float(x) for x in flat[:3])
        with self._totals_lock:
            t = self._totals
            t["rows"] += rows
            t["outliers"] += outliers
            t["batches"] += window_batches
            t["drift_sum"] = t["drift_sum"] + flat[3:3 + _D]
            if window_batches:
                t["drift_last"] = flat[3 + _D:]
            rows, outliers, batches = t["rows"], t["outliers"], t["batches"]
            drift_sum, drift_last = t["drift_sum"], t["drift_last"]
        drift_mean = drift_sum / max(batches, 1.0)
        return {
            "rows": rows,
            "outliers": outliers,
            "batches": batches,
            "drift_last": dict(
                zip(SCHEMA.feature_names, drift_last.round(6).tolist())
            ),
            "drift_mean": dict(
                zip(SCHEMA.feature_names, drift_mean.round(6).tolist())
            ),
            "drift_sum": drift_sum.tolist(),
        }

    def seed_monitor_totals(self, rows: float, outliers: float, batches: float,
                            drift_sum: np.ndarray, drift_last: np.ndarray) -> None:
        """Start the host totals from a predecessor's last published
        aggregate (the ring plane's respawned engine process), so the
        exported counters stay monotone across engine processes."""
        with self._totals_lock:
            self._totals.update(
                rows=float(rows), outliers=float(outliers), batches=float(batches),
                drift_sum=np.asarray(drift_sum, np.float64).copy(),
                drift_last=np.asarray(drift_last, np.float64).copy(),
            )

    def _fold_back(self, window: torch.Tensor) -> None:
        """Merge an unread window (the older) into the live accumulator
        (the newer) in place: counters and sums add, ``drift_last`` stays
        the live one's unless it folded no batches
        (``merge_accumulators``)."""
        older = _acc_views(window)
        live = self._acc
        live.drift_last.copy_(
            torch.where(live.batches > 0, live.drift_last, older.drift_last)
        )
        self._acc_flat[: 3 + _D].add_(window[: 3 + _D])


    # ------------------------------------------------------ sharded serving
    def _tell(self, op: str, *args) -> None:
        """On the lead of a mesh with followers, announce one operation of
        this engine (caller holds the mesh's lock); nothing elsewhere."""
        mesh = self._mesh
        if mesh is not None and mesh.lead and mesh.followers:
            mesh.announce((op, self._sid, *args))

    def follow_op(self, op: str, *args) -> None:
        """A follower's side of one operation the lead announced for this
        engine (``serve/shards.py::follow`` calls it, in the lead's lock
        order): the same device work on this rank's blocks, so every
        collective meets its peers. The lead fetches; a follower copies
        nothing to the host."""
        if op == "run":
            seq, tier, served, batch = args
            with self._acc_lock, self._on_stream():
                if self._cuda:
                    batch = torch.from_numpy(batch).pin_memory()
                self._launch(self._gens[seq], tier, served, batch)
        elif op == "ready":
            seq, tier, lead, run = args
            gen = self._gens[seq]
            with self._acc_lock:
                if self._scratch is None and run and not self._use_graphs:
                    with self._on_stream():
                        self._scratch = init_accumulator(self.device)
                try:
                    self._ready_one(gen, tier, lead, self._scratch, run)
                except MeshOutOfStep:
                    raise
                except Exception:
                    # Every rank agreed the shape is not ready: the lead
                    # raises or degrades, and announces what it runs instead.
                    logger.warning("follower: readying %s %s failed", tier, lead,
                                   exc_info=True)
        elif op == "stage":
            candidate, seq = args  # this rank's twin of the lead's candidate
            self._gens[seq] = self._stage(candidate, seq)
        elif op == "exchange":
            seq, kind, buckets = args
            if kind == "regrid":
                self._seq = seq
                staged = dataclasses.replace(self._gen, buckets=buckets, seq=seq)
            else:
                staged = None if seq is None else self._gens[seq]
            self._exchange(staged, kind)
            self._gens = {g.seq: g for g in (self._gen, self._retired) if g is not None}
        elif op == "snapshot":
            with self._acc_lock, self._on_stream():
                self._window = self._acc_flat.clone()
                self._acc_flat.zero_()
        elif op == "fold_back":
            with self._acc_lock, self._on_stream():
                self._fold_back(self._window)
        else:
            raise ValueError(f"unknown sharded-serving operation {op!r}")


def dist_backend(mesh) -> str:
    """The backend of a mesh's 'model' group (``nccl`` or ``gloo``)."""
    import torch.distributed as dist

    return str(dist.get_backend(mesh.group("model")))


def _host_batch(lead: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """Zeroed host ``(cat_ids, numeric, mask)`` arrays of ``lead`` rows."""
    return tuple(
        np.zeros((*lead, *tail), dtype)
        for tail, dtype in (((SCHEMA.num_categorical,), np.int32),
                            ((SCHEMA.num_numeric,), np.float32),
                            ((), bool))
    )


def _acc_views(flat: torch.Tensor) -> MonitorAccumulator:
    """The accumulator fields as views of one flat buffer."""
    return MonitorAccumulator(
        rows=flat[0], outliers=flat[1], batches=flat[2],
        drift_sum=flat[3:3 + _D], drift_last=flat[3 + _D:],
    )
