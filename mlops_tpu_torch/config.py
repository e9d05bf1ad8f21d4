"""Configuration: the JAX package's config tree.

``ModelConfig`` and ``TrainConfig`` are copies of the JAX dataclasses,
field for field with their defaults, so a bundle manifest's
``model_config`` and a job's TOML parse into them. ``data``,
``monitor`` and ``registry`` hold the fields the ported paths read;
``serve`` the keys of the JAX package's ``ServeConfig`` that its
single-process server reads (``ServeConfig.validate`` with the same
messages). ``hpo`` (the ``tune`` sweep), ``score`` (bulk scoring) and
``lifecycle`` (the closed loop, whose gate bounds also grade the quant
student) are the JAX package's, field for field. Two port-only knobs,
``serve.device`` and ``train.device``, say where the entry points run:
the card unless the caller writes ``cpu``.

``serve`` also holds the keys of the multi-worker ring plane
(``serve.workers`` >= 2: ``serve/frontend.py``), of its engine replica
set (``serve.engine_replicas``, ``serve.replica_affinity_slack``) and of
the tenant fleet (``serve.tenants_path``: ``tenancy/``), and ``cache``
the warm start (``cache.dir``: the kernel libraries' cache,
``compilecache/``).

``autotune`` is the JAX package's section, field for field with its
``validate`` (the traffic-shape autotuner, ``autotune/``).
``serve.loop_lag_monitor`` arms the event-loop lag sanitizer
(``analysis/loopcheck.py``) on either serving plane.

``load_config`` builds the tree as the JAX package's does: defaults <-
TOML (``--config <file>``) <- ``MLOPS_TPU_<SECTION>_<FIELD>``
environment overrides (``MLOPS_TPU_TRAIN_STEPS=7``; a malformed or
unknown key warns and is skipped) <- positional ``section.field=value``
overrides (``train.steps=200``, ``serve.port=5001``); a string tuple's
items separate on ``;`` there (``hpo.architectures='hidden_dims=16,
embed_dim=8;family=bert'``), any other tuple's on ``,``.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
import typing
import warnings
from pathlib import Path
from typing import Any


# tpulint Layer-4 manifest (analysis/contracts.py TPU503): every
# ``*Config`` field here must be read outside this module.
TPULINT_CONFIG_MODULE = True


@dataclasses.dataclass
class DataConfig:
    train_path: str = ""  # train: CSV to train on (empty -> synthetic);
    # predict-file: the history CSV to score
    rows: int = 50_000  # synthetic row count
    seed: int = 0
    valid_fraction: float = 0.2  # held-out split (seed 2024)


@dataclasses.dataclass
class ModelConfig:
    """The JAX package's ``ModelConfig`` (``mlops_tpu/config.py:42``),
    field for field with its defaults. The port builds every family of
    the exact tier and its deep ensembles (``models.build_model``), the
    masked-LM of pretraining and the dense doc model (``family="bert"``,
    ``doc_records > 1``) from it."""

    family: str = "mlp"  # mlp | ft_transformer | moe | linear | bert | gbm | rf
    hidden_dims: tuple[int, ...] = (256, 256, 128)
    embed_dim: int = 16
    dropout: float = 0.1
    precision: str = "bf16"  # compute dtype: bf16 | f32 (params stay f32)
    ensemble_size: int = 1
    depth: int = 3
    heads: int = 8
    token_dim: int = 64
    num_experts: int = 8
    n_estimators: int = 300
    max_tree_depth: int = 8
    doc_records: int = 1  # >1: one document of doc_records records
    # (seq = 2 + 46R tokens), the long-context doc model
    seq_parallel: bool = False  # ring attention over a 'seq' mesh axis
    pipeline_stages: int = 0
    tensor_parallel: int = 0

    @property
    def uses_layout_trainer(self) -> bool:
        """True when this config trains through a layout trainer (the
        doc model, pipeline or tensor parallel) instead of the dense
        single-record ``run_training``: the JAX package's predicate."""
        return bool(
            self.pipeline_stages
            or self.seq_parallel
            or self.doc_records > 1
            or self.tensor_parallel
        )


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (``mlops_tpu/config.py:98``),
    field for field, plus ``device``. The dense trainer reads what the JAX
    ``fit`` reads (warmup_steps and keep_best too; the pipeline-parallel
    knobs are not its); the doc trainer reads batch_size, steps,
    learning_rate, weight_decay, seed, eval_every, checkpoint_every,
    pos_weight and ema_decay, as the JAX doc trainer does. After the fit
    ``run_training`` distills the bulk student (``distill_bulk``, for
    ensembles and the transformer families) and the quant student
    (``distill_quant``), as the JAX package's does. Every trainer streams
    its metrics to TensorBoard too when ``tensorboard_dir`` is set;
    ``init_params`` (a ``pretrain`` file) grafts a pretrained bert trunk
    into the dense trainer's initial params."""

    batch_size: int = 1024
    steps: int = 2000
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    seed: int = 0
    eval_every: int = 200
    checkpoint_every: int = 500
    pos_weight: float = 1.0
    init_params: str = ""
    tensorboard_dir: str = ""
    keep_best: bool = True
    distill_bulk: bool = True
    distill_quant: bool = False
    pipeline_microbatches: int = 8
    pipeline_remat: bool = False
    ema_decay: float = 0.0
    device: str = "cuda"  # "cpu" trains on the CPU (the plain torch route)


@dataclasses.dataclass
class HPOConfig:
    """The JAX package's ``HPOConfig`` (``mlops_tpu/config.py:145``),
    field for field with its defaults: the ``tune`` sweep
    (``train/hpo.py``). Trials of one architecture train stacked in one
    program per step; ``architectures`` specs (comma-separated
    ``ModelConfig`` overrides, tuples joined by ``x``) loop as groups."""

    trials: int = 10
    seed: int = 2024
    objective: str = "roc_auc"  # selection metric (validation_<objective>_score)
    steps: int = 1000
    strategy: str = "random"  # random | sha (successive halving)
    eta: int = 3  # sha: keep the top 1/eta per rung
    sha_rungs: int = 3  # sha rung count (the last trains the finalists)
    lr_log10: tuple[float, float] = (-3.7, -2.0)  # log-uniform bounds
    wd_log10: tuple[float, float] = (-6.0, -3.0)
    pos_weight_range: tuple[float, float] = (1.0, 4.0)  # uniform
    architectures: tuple[str, ...] = ()  # e.g. "family=mlp,hidden_dims=64x64"


@dataclasses.dataclass
class MonitorConfig:
    outlier_quantile: float = 0.95
    drift_ref_size: int = 2048  # per-feature reference sample for K-S


class ServeConfigError(ValueError):
    """An inconsistent serving geometry, named at startup
    (``ServeConfig.validate``), as the JAX package's is."""


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's ``ServeConfig`` keys of the single-process
    server and of the multi-worker ring plane, with their defaults, plus
    ``device``."""

    host: str = "0.0.0.0"
    port: int = 5000
    service_name: str = "credit-default-api"
    model_directory: str = "model"  # a bundle directory
    max_batch: int = 256  # request-size cap (413 above it), clamped to the
    # largest warmed bucket so serving never pads past the bucket grid;
    # predict-file: documents per forward chunk
    warmup_batch_sizes: tuple[int, ...] = (1, 8, 64, 256)
    batch_window_ms: float = 1.0  # micro-batching window: concurrent small
    # requests arriving within it coalesce into one grouped dispatch
    # (serve/batcher.py); 0 turns coalescing off. In continuous mode it
    # caps the measured admit deadline
    max_group: int = 64  # most requests one grouped dispatch carries,
    # clamped to the largest slot bucket
    batch_mode: str = "continuous"  # "continuous": pending requests join
    # the next free in-flight dispatch slot, and only an empty pipe waits
    # (batch_admit_fraction x the measured dispatch time, capped by the
    # window); "windowed": every group holds the full window first
    batch_admit_fraction: float = 0.5
    serve_tier: str = "exact"  # exact | quant | auto, as in the JAX package
    max_inflight: int = 4  # overlapped grouped dispatches in flight
    max_workers: int = 8  # scoring thread pool size: the dispatch bound,
    # the fetch ring and one thread of headroom must fit it
    monitor_fetch_every_s: float = 2.0  # cadence of the monitor
    # aggregate's device -> host read while traffic flows (0: no timer)
    monitor_fetch_every_requests: int = 512  # also read after this many
    # predict requests (0: no request trigger); /metrics reads fresh
    request_timeout_s: float = 30.0  # per-request deadline on the predict
    # path (504 past it; a stalled device must not wedge every
    # connection); x-request-deadline-ms tightens it per request. 0: none
    profile_dir: str = ""  # torch.profiler trace directory of the
    # /debug/profile routes; empty: the routes answer 404
    tier_routing: bool = False  # per-request SLO tier routing: the engine
    # also holds the bundle's other gated tier and each request's
    # x-slo-class (or a tight x-request-deadline-ms) picks one
    slo_cheap_deadline_ms: float = 50.0  # a deadline budget at or under
    # this routes the cheap class (<= 0: only the header routes)
    brownout_demote_depth: float = 0.75  # in-flight depth fraction past
    # which default-class requests demote to the cheaper tier
    brownout_restore_depth: float = 0.5  # and under which they stop
    model_shards: int = 1  # ranks (one card each) one engine's params split over
    device: str = "cuda"  # "cpu" runs on the CPU (plain torch route)
    drain_deadline_s: float = 30.0  # SIGTERM: how long busy exchanges may
    # take to finish their response before connections are force-closed
    workers: int = 0  # HTTP front-end processes: 0 and 1 are the
    # single-process server; N >= 2 binds one port from N SO_REUSEPORT
    # processes feeding one engine process over the shared-memory ring
    ring_slots_small: int = 64  # per-front-end request slots of
    # GROUP_ROW_BUCKET rows (the coalescable class)
    ring_slots_large: int = 4  # per-front-end slots of max_batch rows
    shed_retry_after_s: int = 1  # Retry-After of a shed 503
    zygote_join_deadline_s: float = 35.0  # supervisor drain: one budget
    # for every front end's join before SIGKILL; covers drain_deadline_s
    engine_zygote_join_s: float = 50.0  # then the engine's drain budget
    engine_respawn_eta_s: float = 5.0  # Retry-After of a brownout 503
    # while the engine process respawns
    log_sample_rate: float = 1.0  # fraction of requests whose two-event
    # log pair is written; non-200 answers always log
    engine_replicas: int = 1  # engine replica processes behind the ring
    # (serve --replicas E; needs serve.workers >= 2): the front ends route
    # each submit least-loaded, and a dead replica is a 1/E brownout
    replica_affinity_slack: int = 4  # slots a sticky (tenant, small
    # class) replica may trail the least-loaded one before the router
    # moves that tenant's small requests
    tenants_path: str = ""  # a tenants.toml (serve --tenants): N tenants
    # served from one plane, routed by the x-tenant header
    loop_lag_monitor: bool = False  # arm the LoopLagSanitizer
    # (analysis/loopcheck.py) on every serving event loop: per-callback
    # wall time, drained into the mlops_tpu_event_loop_lag_ms gauge
    loop_lag_slow_ms: float = 100.0  # callbacks at or above this are
    # kept for the slow-callback report; read with loop_lag_monitor=true

    def validate(self) -> "ServeConfig":
        """Reject an inconsistent geometry with the JAX package's messages,
        one per broken invariant, all in one ``ServeConfigError``."""
        problems: list[str] = []
        if self.max_workers < 1:
            problems.append(f"serve.max_workers={self.max_workers} must be >= 1")
        if self.max_batch < 1:
            problems.append(f"serve.max_batch={self.max_batch} must be >= 1")
        inflight_cap = max(1, self.max_workers - 2)
        if not 1 <= self.max_inflight <= inflight_cap:
            problems.append(
                f"serve.max_inflight={self.max_inflight} outside "
                f"[1, max(1, serve.max_workers - 2) = {inflight_cap}]: the "
                "dispatch bound, the fetch ring, and one thread of headroom "
                "(solo fast path / monitor fetch) must fit the predict pool "
                "— raise serve.max_workers or lower serve.max_inflight"
            )
        if self.workers < 0:
            problems.append(f"serve.workers={self.workers} must be >= 0")
        if self.batch_window_ms < 0:
            problems.append(
                f"serve.batch_window_ms={self.batch_window_ms} must be "
                ">= 0 (0 disables coalescing; negative has no meaning)"
            )
        if self.max_group < 2:
            problems.append(
                f"serve.max_group={self.max_group} must be >= 2 (a group "
                "of one is the solo path; the batcher clamps the top end "
                "to the largest warmed slot bucket)"
            )
        if self.batch_mode not in ("continuous", "windowed"):
            problems.append(
                f"serve.batch_mode={self.batch_mode!r} must be "
                "'continuous' or 'windowed'"
            )
        if not 0.0 < self.batch_admit_fraction <= 1.0:
            problems.append(
                f"serve.batch_admit_fraction={self.batch_admit_fraction} "
                "must be in (0, 1] — it scales the measured dispatch time "
                "into the empty-pipe admit deadline; more than one whole "
                "dispatch of waiting buys nothing a deeper group wouldn't"
            )
        if self.serve_tier not in ("exact", "quant", "auto"):
            problems.append(
                f"serve.serve_tier={self.serve_tier!r} must be 'exact', "
                "'quant' or 'auto'"
            )
        if not 0.0 < self.brownout_demote_depth <= 1.0:
            problems.append(
                f"serve.brownout_demote_depth={self.brownout_demote_depth} "
                "must be in (0, 1] — it is a fraction of admission depth"
            )
        if not 0.0 <= self.brownout_restore_depth < self.brownout_demote_depth:
            problems.append(
                f"serve.brownout_restore_depth={self.brownout_restore_depth}"
                " must be in [0, serve.brownout_demote_depth ="
                f" {self.brownout_demote_depth}) — restoring at or above "
                "the demote threshold flaps the brownout on every sample"
            )
        if self.drain_deadline_s <= 0:
            problems.append(
                f"serve.drain_deadline_s={self.drain_deadline_s} must be "
                "> 0 (a zero drain window severs in-flight responses on "
                "every rollout)"
            )
        if self.zygote_join_deadline_s < self.drain_deadline_s:
            problems.append(
                f"serve.zygote_join_deadline_s={self.zygote_join_deadline_s}"
                f" must cover serve.drain_deadline_s={self.drain_deadline_s}"
                " (the zygote joins children that are themselves draining "
                "for the full drain window)"
            )
        if self.engine_zygote_join_s < self.zygote_join_deadline_s + 5:
            problems.append(
                f"serve.engine_zygote_join_s={self.engine_zygote_join_s} "
                "must exceed serve.zygote_join_deadline_s + 5 "
                f"(= {self.zygote_join_deadline_s + 5:g}: the zygote's "
                "child-join budget plus its SIGKILL grace — a shorter "
                "engine wait SIGKILLs a zygote that is still joining "
                "cleanly)"
            )
        if self.workers > 1:
            if self.ring_slots_small < 1 or self.ring_slots_large < 1:
                problems.append(
                    f"serve.ring_slots_small={self.ring_slots_small} / "
                    f"serve.ring_slots_large={self.ring_slots_large} must "
                    "each be >= 1 with serve.workers > 1 (every front end "
                    "needs at least one slot per bucket class, or whole "
                    "request classes would shed 100%)"
                )
            if self.shed_retry_after_s < 1:
                problems.append(
                    f"serve.shed_retry_after_s={self.shed_retry_after_s} "
                    "must be >= 1 (the shed 503 contract promises a "
                    "positive Retry-After)"
                )
            if self.engine_respawn_eta_s <= 0:
                problems.append(
                    f"serve.engine_respawn_eta_s={self.engine_respawn_eta_s}"
                    " must be > 0 (the brownout 503 contract promises a "
                    "positive respawn-ETA Retry-After)"
                )
        if self.engine_replicas < 1:
            problems.append(
                f"serve.engine_replicas={self.engine_replicas} must be "
                ">= 1"
            )
        if self.engine_replicas > 1 and self.workers < 2:
            problems.append(
                f"serve.engine_replicas={self.engine_replicas} needs the "
                "multi-worker ring plane (serve.workers >= 2): the "
                "single-process server has no descriptor ring to fan out"
            )
        if self.replica_affinity_slack < 0:
            problems.append(
                f"serve.replica_affinity_slack={self.replica_affinity_slack}"
                " must be >= 0"
            )
        if self.model_shards < 1:
            problems.append(
                f"serve.model_shards={self.model_shards} must be >= 1"
            )
        if not 0.0 < self.log_sample_rate <= 1.0:
            problems.append(
                f"serve.log_sample_rate={self.log_sample_rate} must be in "
                "(0, 1] (0 would silence even the always-logged errors' "
                "InferenceData events; sample DOWN, never off)"
            )
        if self.loop_lag_slow_ms <= 0:
            problems.append(
                f"serve.loop_lag_slow_ms={self.loop_lag_slow_ms} must be "
                "> 0 (0 would record every callback as slow, unbounded "
                "attribution overhead)"
            )
        if problems:
            raise ServeConfigError("; ".join(problems))
        return self


@dataclasses.dataclass
class ScoreConfig:
    """The JAX package's ``ScoreConfig`` (``mlops_tpu/config.py:534``):
    bulk scoring (``score-batch``, ``parallel/bulk.py`` and
    ``data/stream.py``)."""

    chunk_rows: int = 131_072  # rows per chunk program
    drift_sample: int = 65_536  # bounded sample for dataset-level drift
    pipeline_depth: int = 2  # bounded-queue depth of the staged executor
    # (data/pipeline_exec.py); 1 = strict serial, bit-identical outputs
    output_path: str = ""  # optional .npz with predictions/outliers
    # (streaming: the output CSV)
    streaming: bool = False  # stream CSV chunks through the chunk program
    # with one-chunk peak memory (data/stream.py)
    exact: bool = False  # True forces the serving-identical model; False
    # auto-routes through the distilled bulk student on the CPU
    # (parallel/bulk.py use_distilled_bulk)


class LifecycleConfigError(ValueError):
    """An inconsistent lifecycle geometry, named at startup."""


@dataclasses.dataclass
class LifecycleConfig:
    """The JAX package's ``LifecycleConfig`` (``mlops_tpu/config.py:562``),
    field for field with its defaults and validation: the closed loop's
    knobs (``lifecycle/``; ``serve`` runs it with ``lifecycle.enabled=true``
    on either plane) and the bounds ``quant_tier_gates`` grades the quant
    student by."""

    enabled: bool = False
    dir: str = "lifecycle"
    labeled_path: str = ""
    drift_threshold: float = 0.9
    outlier_threshold: float = 0.5
    min_window_rows: int = 256
    hysteresis_windows: int = 2
    cooldown_s: float = 300.0
    tick_s: float = 1.0
    reservoir_rows: int = 8192
    retrain_steps: int = 300
    retrain_batch_size: int = 256
    min_labeled_rows: int = 512
    refit_preprocessor: bool = False
    mirror_fraction: float = 0.1
    shadow_min_mirrors: int = 32
    shadow_max_s: float = 600.0
    max_auc_drop: float = 0.01  # a student may trail its teacher's AUC by
    # at most this on the held-out split
    max_ece: float = 0.1  # expected-calibration-error bound
    max_p99_ratio: float = 2.0
    auto_promote: bool = True
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1800.0

    def validate(self) -> "LifecycleConfig":
        """Reject an inconsistent geometry with the JAX package's
        messages, all in one ``LifecycleConfigError``."""
        problems: list[str] = []
        if not 0.0 < self.drift_threshold <= 1.0:
            problems.append(
                f"lifecycle.drift_threshold={self.drift_threshold} must be "
                "in (0, 1] (drift scores are 1 - p_val)"
            )
        if not 0.0 < self.outlier_threshold <= 1.0:
            problems.append(
                f"lifecycle.outlier_threshold={self.outlier_threshold} "
                "must be in (0, 1] (a rate)"
            )
        if self.hysteresis_windows < 1:
            problems.append(
                f"lifecycle.hysteresis_windows={self.hysteresis_windows} "
                "must be >= 1 (0 would fire on no evidence at all)"
            )
        if not 0.0 <= self.mirror_fraction <= 1.0:
            problems.append(
                f"lifecycle.mirror_fraction={self.mirror_fraction} must be "
                "in [0, 1]"
            )
        if self.reservoir_rows < 1:
            problems.append(
                f"lifecycle.reservoir_rows={self.reservoir_rows} must be >= 1"
            )
        if self.retrain_steps < 1:
            problems.append(
                f"lifecycle.retrain_steps={self.retrain_steps} must be >= 1"
            )
        if self.max_p99_ratio <= 0:
            problems.append(
                f"lifecycle.max_p99_ratio={self.max_p99_ratio} must be > 0"
            )
        if self.tick_s <= 0:
            problems.append(
                f"lifecycle.tick_s={self.tick_s} must be > 0 (a zero tick "
                "turns the controller thread into a busy loop of "
                "fetch-and-reset device round trips contending the "
                "accumulator lock with live traffic)"
            )
        if self.cooldown_s < 0:
            problems.append(
                f"lifecycle.cooldown_s={self.cooldown_s} must be >= 0"
            )
        if self.min_window_rows < 1:
            problems.append(
                f"lifecycle.min_window_rows={self.min_window_rows} must "
                "be >= 1"
            )
        if self.min_labeled_rows < 2:
            problems.append(
                f"lifecycle.min_labeled_rows={self.min_labeled_rows} must "
                "be >= 2 (the holdout split needs both classes a chance "
                "to exist)"
            )
        if self.shadow_min_mirrors < 0:
            problems.append(
                f"lifecycle.shadow_min_mirrors={self.shadow_min_mirrors} "
                "must be >= 0"
            )
        if self.shadow_max_s <= 0:
            problems.append(
                f"lifecycle.shadow_max_s={self.shadow_max_s} must be > 0 "
                "(the shadow phase needs a bounded evaluation deadline)"
            )
        if self.breaker_failures < 1:
            problems.append(
                f"lifecycle.breaker_failures={self.breaker_failures} must "
                "be >= 1 (0 would open the breaker on no evidence)"
            )
        if self.breaker_cooldown_s < 0:
            problems.append(
                f"lifecycle.breaker_cooldown_s={self.breaker_cooldown_s} "
                "must be >= 0"
            )
        if problems:
            raise LifecycleConfigError("; ".join(problems))
        return self


@dataclasses.dataclass
class RegistryConfig:
    root: str = "registry"  # a local directory or a gs://bucket/prefix
    model_name: str = "credit-default-uci-custom"
    experiment_name: str = "credit-default-uci-train"
    run_root: str = "runs"  # per-run artifacts: metrics.jsonl, checkpoints
    run_name: str = ""  # stable run-directory name: a rerun with the same
    # name resumes from its checkpoints; empty = a fresh timestamped one
    promote_version: str = ""  # `promote` CLI: version to move
    promote_stage: str = "staging"  # `promote` CLI: target stage
    gc_keep: int = 0  # `gc` CLI: also prune unstaged versions beyond the
    # newest N (0 = crash orphans only)


class TraceConfigError(ValueError):
    """An inconsistent tracing geometry, named at startup (the
    ``ServeConfigError`` discipline applied to the tracing knobs)."""


@dataclasses.dataclass
class TraceConfig:
    """The JAX package's ``TraceConfig`` (``mlops_tpu/config.py:719``),
    its defaults and validation: request tracing and shape/goodput
    telemetry on both serving planes (``trace/``). Disabled by default —
    disarmed, the hot path pays one ``is None`` check per request."""

    enabled: bool = False
    dir: str = "traces"  # span JSONL root: the single-process server
    # writes spans.jsonl, each multi-worker front end spans-w{N}.jsonl;
    # `python -m mlops_tpu_torch trace-report trace.dir=<dir>`
    # aggregates them
    ring_capacity: int = 4096  # bounded span buffer per process; a full
    # buffer DROPS (counted in mlops_tpu_trace_dropped_total) instead of
    # ever back-pressuring the request path
    flush_interval_s: float = 0.5  # background writer cadence; the drain
    # path flushes everything regardless, so this only bounds how long a
    # span sits in memory while the server runs
    tenant: str = ""  # `trace-report` filter (`--tenant` flag sugar):
    # only aggregate spans carrying this tenant label — multi-tenant
    # planes (mlops_tpu/tenancy/) stamp every span with its tenant;
    # pre-tenancy spans count as "default". Empty = all tenants
    replica: int = -1  # `trace-report` filter (`--replica` flag sugar):
    # only aggregate spans served by this engine replica (the ring
    # plane stitches the router's choice into every span; pre-replica
    # spans count as replica 0). -1 = all replicas
    ledger: bool = False  # `trace-report --ledger` flag sugar: report
    # the device-time cost ledger (slo.ledger_dir) ranked by
    # cost_ms_per_row instead of aggregating span files

    def validate(self) -> "TraceConfig":
        problems: list[str] = []
        if self.ring_capacity < 1:
            problems.append(
                f"trace.ring_capacity={self.ring_capacity} must be >= 1"
            )
        if self.flush_interval_s <= 0:
            problems.append(
                f"trace.flush_interval_s={self.flush_interval_s} must be "
                "> 0 (a zero interval busy-loops the writer thread)"
            )
        if self.enabled and not self.dir:
            problems.append(
                "trace.enabled=true requires trace.dir (the span JSONL "
                "root)"
            )
        if problems:
            raise TraceConfigError("; ".join(problems))
        return self


class SLOConfigError(ValueError):
    """An inconsistent SLO geometry, named at startup (the
    ``ServeConfigError`` discipline applied to the SLO knobs)."""


@dataclasses.dataclass
class SLOConfig:
    """The JAX package's ``SLOConfig`` (``mlops_tpu/config.py:774``), its
    defaults and validation (``slo/``): SLO/error-budget accounting with
    multi-window multi-burn-rate alerts, the anomaly-triggered flight
    recorder, and the per-entry device-time cost ledger. Disabled by
    default — disarmed, every hot path pays one ``is None`` check."""

    enabled: bool = False
    # ------------------------------------------------------------- targets
    availability_target: float = 0.999  # fraction of /predict requests
    # answered without a server-side failure (5xx: 500s, shed 503s, and
    # deadline 504s all spend budget — a shed request is not goodput)
    latency_target: float = 0.99  # fraction of requests answered inside
    # the latency threshold below
    latency_threshold_ms: float = 50.0  # measured against the existing
    # latency histogram: the EFFECTIVE threshold is the smallest bucket
    # edge >= this value (ServingMetrics.LATENCY_BUCKETS)
    tick_s: float = 1.0  # evaluation cadence (the single-process plane's
    # timer task; the ring plane's lead-replica telemetry loop). The
    # alert contract is "flips within two ticks of the counters
    # crossing" — tune down for chaos drills, up for huge fleets
    # --------------------------------------------------------- burn alerts
    # The SRE-workbook multiwindow multi-burn-rate pairs: each alert
    # requires BOTH its windows over the threshold (long filters blips,
    # short ends the alert fast once the burn stops). Defaults are the
    # classic 30-day-budget numbers; chaos drills shrink the windows.
    fast_burn_threshold: float = 14.4  # page: budget gone in ~2 days
    slow_burn_threshold: float = 6.0  # ticket: budget gone in ~5 days
    fast_short_s: float = 300.0  # 5m
    fast_long_s: float = 3600.0  # 1h
    slow_short_s: float = 21600.0  # 6h
    slow_long_s: float = 259200.0  # 3d
    # ---------------------------------------------------- flight recorder
    flightrec_enabled: bool = True  # armed with slo.enabled: each serving
    # process keeps a bounded in-memory ring of recent request summaries
    # (+ spans when tracing is armed) and dumps it atomically on
    # anomaly — burn alert, engine respawn, 5xx/504 spike, breaker open,
    # SIGTERM-with-evidence. A clean run writes NOTHING.
    flightrec_dir: str = "runs"  # dump directory (flightrec-*.json)
    flightrec_capacity: int = 2048  # events per process ring
    flightrec_cooldown_s: float = 30.0  # min seconds between triggered
    # dumps per process (a sustained burn produces a bounded stream)
    flightrec_keep: int = 8  # retention: newest N dumps kept in the dir
    flightrec_spike_errors: int = 8  # 5xx/504 spike trigger: this many
    # server-side failures inside the window below trips a dump even
    # when no burn alert is armed to notice
    flightrec_spike_window_s: float = 5.0
    # --------------------------------------------------------- cost ledger
    ledger_dir: str = ""  # per-entry device-time cost ledger root
    # (slo/ledger.py): empty = OFF. Set it and every packed
    # dispatch accounts (entry, rows, padded rows, device-path seconds)
    # into <dir>/ledger.json — persisted atomically, ACCUMULATED across
    # runs, keyed by entry + model fingerprint (a regrid/promotion never
    # cross-pollutes), exported as mlops_tpu_entry_* series and ranked
    # by `trace-report --ledger`. Arms independently of
    # slo.enabled: the ledger is autotuner input, not alerting.
    ledger_flush_s: float = 30.0  # background flush cadence

    def validate(self) -> "SLOConfig":
        problems: list[str] = []
        for name, target in (
            ("availability_target", self.availability_target),
            ("latency_target", self.latency_target),
        ):
            if not 0.0 < target < 1.0:
                problems.append(
                    f"slo.{name}={target} must be in (0, 1) — a target of "
                    "1.0 leaves zero error budget and every burn rate "
                    "undefined"
                )
        if self.latency_threshold_ms <= 0:
            problems.append(
                f"slo.latency_threshold_ms={self.latency_threshold_ms} "
                "must be > 0"
            )
        else:
            # The SLO measures against the serving latency histogram;
            # a threshold past its largest FINITE edge would map to the
            # +Inf bucket and count EVERY request as good — a silently
            # dead latency alert, exactly what the always-emit contract
            # exists to prevent. (Lazy import: serve/metrics never
            # imports config back.)
            from mlops_tpu_torch.serve.metrics import LATENCY_BUCKETS

            max_edge = LATENCY_BUCKETS[-2]
            if self.latency_threshold_ms > max_edge:
                problems.append(
                    f"slo.latency_threshold_ms={self.latency_threshold_ms}"
                    f" exceeds the largest finite latency bucket "
                    f"({max_edge:g} ms) — every request would count as "
                    "good and the latency alerts could never fire"
                )
        if self.tick_s <= 0:
            problems.append(
                f"slo.tick_s={self.tick_s} must be > 0 (a zero tick "
                "busy-loops the evaluator)"
            )
        if self.fast_burn_threshold <= 0 or self.slow_burn_threshold <= 0:
            problems.append(
                "slo.fast_burn_threshold/slow_burn_threshold must be > 0"
            )
        if not (
            0 < self.fast_short_s < self.fast_long_s
            and 0 < self.slow_short_s < self.slow_long_s
        ):
            problems.append(
                "slo burn windows must satisfy 0 < fast_short_s < "
                "fast_long_s and 0 < slow_short_s < slow_long_s "
                f"(got {self.fast_short_s}/{self.fast_long_s} and "
                f"{self.slow_short_s}/{self.slow_long_s}): each alert "
                "pairs a short window with its long one"
            )
        else:
            # Burn gauges carry a window LABEL dimension ("5m"/"1h"):
            # two windows collapsing to one label (90 vs 90.5 s both →
            # "90s") would silently overwrite each other's burns and
            # drop a series — reject the collision by name instead.
            from mlops_tpu_torch.slo.engine import window_label

            windows = (self.fast_short_s, self.fast_long_s,
                       self.slow_short_s, self.slow_long_s)
            labels = [window_label(w) for w in windows]
            if len(set(labels)) != len(labels):
                problems.append(
                    f"slo burn windows {windows} collapse to duplicate "
                    f"window labels {labels}: every window needs a "
                    "distinct whole-second label (the burn gauges' "
                    "window dimension)"
                )
        if self.flightrec_capacity < 1:
            problems.append(
                f"slo.flightrec_capacity={self.flightrec_capacity} must "
                "be >= 1"
            )
        if self.flightrec_cooldown_s < 0:
            problems.append(
                f"slo.flightrec_cooldown_s={self.flightrec_cooldown_s} "
                "must be >= 0"
            )
        if self.flightrec_keep < 1:
            problems.append(
                f"slo.flightrec_keep={self.flightrec_keep} must be >= 1"
            )
        if self.flightrec_spike_errors < 1:
            problems.append(
                f"slo.flightrec_spike_errors={self.flightrec_spike_errors}"
                " must be >= 1"
            )
        if self.flightrec_spike_window_s <= 0:
            problems.append(
                f"slo.flightrec_spike_window_s="
                f"{self.flightrec_spike_window_s} must be > 0"
            )
        if self.ledger_flush_s <= 0:
            problems.append(
                f"slo.ledger_flush_s={self.ledger_flush_s} must be > 0"
            )
        if problems:
            raise SLOConfigError("; ".join(problems))
        return self


class AutotuneConfigError(ValueError):
    """An inconsistent autotuner geometry, named at startup (the
    ``ServeConfigError`` discipline applied to the gridtuner knobs)."""


@dataclasses.dataclass
class AutotuneConfig:
    """The JAX package's ``AutotuneConfig`` (``mlops_tpu/config.py:942``),
    field for field with its defaults and ``validate``: the traffic-shape
    autotuner (``autotune/``) fits a measured per-entry cost model from
    the device-time ledger, searches bucket grids against the observed
    shape histogram and hot-regrids the engine with the winner. Disabled
    by default; the one-shot offline pass is ``python -m mlops_tpu_torch
    autotune``."""

    enabled: bool = False
    interval_s: float = 60.0  # periodic evaluation cadence (its own
    # thread, off the request path — the LifecycleController discipline)
    min_dispatches: int = 512  # observed dispatches required before a
    # plan is even considered: a near-empty shape histogram is noise,
    # and regridding on noise churns the graph pool for nothing
    max_entries: int = 16  # capture budget: the most solo-bucket entries
    # a plan may carry (each is one CUDA graph per tier at warm time; group
    # geometries stay the full fixed grid and don't count against this)
    min_gain_pct: float = 5.0  # predicted useful_rows_per_s gain below
    # which a plan is rejected (outcome="rejected"): swapping grids for
    # sub-noise gains invalidates warm telemetry for nothing
    apply: bool = True  # False = dry-run: plans are computed, exported,
    # and persisted, but never hot-applied (the human-in-the-loop mode —
    # read the plan, then `serve autotune.apply=true`)
    plan_dir: str = "autotune"  # plan root: the controller (and the
    # offline CLI) writes plan.json here atomically; on the ring plane
    # sibling replicas ADOPT the lead's applied plan from this file,
    # capturing their own graphs (the kernel cache is shared) instead of
    # re-searching
    cooldown_s: float = 300.0  # dead time after any apply/rollback
    # before the next evaluation: measured-gain audit needs a full
    # observation window on the new grid before anyone moves again

    def validate(self) -> "AutotuneConfig":
        problems: list[str] = []
        if self.interval_s <= 0:
            problems.append(
                f"autotune.interval_s={self.interval_s} must be > 0 (a "
                "zero interval busy-loops the controller thread)"
            )
        if self.min_dispatches < 1:
            problems.append(
                f"autotune.min_dispatches={self.min_dispatches} must be "
                ">= 1 (0 would regrid on an empty histogram)"
            )
        if self.max_entries < 2:
            problems.append(
                f"autotune.max_entries={self.max_entries} must be >= 2 "
                "(every grid needs at least a batch-1 bucket and a tail "
                "bucket)"
            )
        if self.min_gain_pct < 0:
            problems.append(
                f"autotune.min_gain_pct={self.min_gain_pct} must be >= 0"
            )
        if self.cooldown_s < 0:
            problems.append(
                f"autotune.cooldown_s={self.cooldown_s} must be >= 0"
            )
        if self.enabled and not self.plan_dir:
            problems.append(
                "autotune.enabled=true requires autotune.plan_dir (the "
                "plan root sibling replicas adopt from)"
            )
        if problems:
            raise AutotuneConfigError("; ".join(problems))
        return self


@dataclasses.dataclass
class CacheConfig:
    """The JAX package's ``CacheConfig`` (``mlops_tpu/config.py:1009``).
    The JAX package caches compiled XLA executables there; the port
    caches its kernel libraries (``compilecache/``): with ``dir`` set,
    every kernel builds into and loads from ``<dir>/kernels/``, and
    ``warmup --cache-dir <dir>`` fills it ahead of serving."""

    dir: str = ""  # empty: the kernels build into build/kernels/
    warmup_workers: int = 0  # parallel nvcc builds of `warmup` (0: serial)


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    hpo: HPOConfig = dataclasses.field(default_factory=HPOConfig)
    monitor: MonitorConfig = dataclasses.field(default_factory=MonitorConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    registry: RegistryConfig = dataclasses.field(default_factory=RegistryConfig)
    score: ScoreConfig = dataclasses.field(default_factory=ScoreConfig)
    lifecycle: LifecycleConfig = dataclasses.field(default_factory=LifecycleConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    autotune: AutotuneConfig = dataclasses.field(default_factory=AutotuneConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)


def _coerce(owner: type, field: str, current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        args = typing.get_args(typing.get_type_hints(owner)[field])
        inner = args[0] if args else str
        body = raw.strip("()[] ")
        if inner is str:
            # String tuples (hpo.architectures) hold comma-containing
            # specs, so their items separate on ';'.
            return tuple(x.strip() for x in body.split(";") if x.strip())
        return tuple(inner(x) for x in body.split(",") if x.strip())
    return raw


def _apply(config: Config, section: str, field: str, value: Any) -> None:
    sub = getattr(config, section, None)
    if sub is None or not hasattr(sub, field):
        raise KeyError(f"unknown config key {section}.{field}")
    current = getattr(sub, field)
    if isinstance(value, str) and not isinstance(current, str):
        value = _coerce(type(sub), field, current, value)
    elif isinstance(current, tuple) and isinstance(value, list):
        value = tuple(value)
    elif isinstance(current, float) and isinstance(value, int):
        value = float(value)
    setattr(sub, field, value)


def load_config(
    overrides: list[str] | None = None,
    toml_path: str | Path | None = None,
    env: dict[str, str] | None = None,
) -> Config:
    """Defaults <- TOML (``toml_path``) <- ``MLOPS_TPU_<SECTION>_<FIELD>``
    in ``env`` (``os.environ`` when None) <- ``section.field=value``
    overrides. An unknown key raises, except in the environment, where
    it warns as in the JAX package."""
    config = Config()
    if toml_path:
        with open(toml_path, "rb") as f:
            doc = tomllib.load(f)
        for section, fields in doc.items():
            for field, value in fields.items():
                _apply(config, section, field, value)
    env = dict(os.environ if env is None else env)
    for key, raw in env.items():
        if not key.startswith("MLOPS_TPU_"):
            continue
        parts = key[len("MLOPS_TPU_"):].lower().split("_", 1)
        if len(parts) != 2:
            warnings.warn(f"ignoring malformed env override {key}", stacklevel=2)
            continue
        section, field = parts
        try:
            _apply(config, section, field, raw)
        except KeyError:
            warnings.warn(f"ignoring unknown env override {key}", stacklevel=2)
    for item in overrides or []:
        key, sep, raw = item.partition("=")
        section, _, field = key.strip("-").partition(".")
        if not sep:
            raise KeyError(f"unknown config override {item!r}")
        _apply(config, section, field, raw)
    if config.serve.model_shards > 1 and config.lifecycle.enabled:
        raise ValueError(
            f"serve.model_shards={config.serve.model_shards} with "
            "lifecycle.enabled refused: the closed loop's candidate engines "
            "over a sharded mesh are not ported (ROADMAP A11c)"
        )
    return config
