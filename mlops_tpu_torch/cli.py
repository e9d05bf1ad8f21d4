"""Command-line entry point: ``python -m mlops_tpu_torch <command> [key=value ...]``.

- ``serve``: serve a bundle over HTTP on the exact tier (the default) or
  the quant tier (``serve.serve_tier=quant``; ``auto`` prefers a gated
  quant tier), concurrent requests coalescing in the micro-batcher; with
  ``serve.tier_routing=true`` on both, each request's SLO class picking
  one; with ``lifecycle.enabled=true`` (``configs/lifecycle_serve.toml``)
  the closed loop runs beside it: drift trigger -> retrain -> shadow ->
  gated hot swap (in the server's process, or with ``serve.workers >= 2``
  in the ring plane's engine process);
- ``lifecycle``: one offline lifecycle pass — retrain a candidate from
  the labeled window (``lifecycle.labeled_path``), grade it against the
  incumbent through the AUC and calibration gates, register it when it
  passes; exit 0 when it passed, 3 when the gates rejected it;
- ``predict-file``: score a CSV with a ``flax`` bundle (the exact tier's
  response JSON) or a record-history CSV with a ``doc`` bundle, and print
  one JSON line (``data.train_path=<csv> serve.model_directory=<bundle>
  [serve.max_batch=N]``);
- ``train``: train an exact-tier model into a ``flax`` bundle
  (``--config configs/train_register_job.toml``; linear, mlp,
  ``ft_transformer``, ``moe``, single-record ``bert`` and deep ensembles
  of any of them, a bert fine-tune from a pretrained trunk with
  ``train.init_params=<pretrained.msgpack>``; over N ranks with
  ``python -m torch.distributed.run --nproc-per-node N -m mlops_tpu_torch
  train ... model.tensor_parallel=K`` or ``model.pipeline_stages=S``, and
  the doc model with ``model.seq_parallel=true``), with the
  distilled bulk student of an ensemble or a transformer family unless
  ``train.distill_bulk=false``, and the gated quant tier with
  ``train.distill_quant=true``) or the long-context doc model into a
  ``doc`` bundle (``--config configs/long_context_job.toml
  model.seq_parallel=false``), and print one JSON line
  (``registry.root=<dir> registry.run_root=<dir>``);
- ``pretrain``: masked-feature pretraining of the bert trunk on
  unlabeled rows (``model.family=bert``) into
  ``<run_dir>/pretrained.msgpack``, one JSON line (pretrained, rows,
  loss_curve);
- ``score-batch``: bulk-score ``data.rows`` synthetic rows or a CSV
  (``data.train_path``) with a ``flax`` bundle and print one JSON line
  (``serve.model_directory=<bundle> [score.output_path=<npz>]``); with
  ``score.streaming=true`` stream the CSV to ``score.output_path`` (a
  CSV);
- ``tune``: the hyperparameter sweep (``--config
  configs/train_register_job.toml``: every trial of an architecture
  trained stacked, ``hpo.strategy=sha`` for successive halving,
  ``hpo.architectures`` for groups), the winner packaged and registered,
  one JSON line;
- ``register`` (``data.train_path=<bundle dir>``, prints the
  ``models:/`` URI), ``promote`` (``registry.promote_version=<n>
  registry.promote_stage=staging|production|none``), ``versions`` and
  ``gc`` (``[registry.gc_keep=N]``) on the registry at
  ``registry.root``;
- ``synth`` (``data.rows`` synthetic rows to ``data.train_path``) and
  ``validate`` (lint a CSV: exit 2 when anything is flagged);
- ``warmup --cache-dir <dir>``: build the kernel libraries the resolved
  bundle serves with into ``<dir>/kernels/`` (every library without a
  bundle) and print one JSON report; a ``serve`` with ``cache.dir`` set
  (``MLOPS_TPU_CACHE_DIR``) loads them from there without nvcc;
- ``trace-report [trace.dir=<dir>] [--tenant T] [--replica R]``: p50/p99
  per stage per entry from a traced server's span files (the table on
  stderr, the JSON on stdout; exit 2 without spans); ``--ledger
  slo.ledger_dir=<dir>`` ranks the cost ledger's entries by cost per row;
- ``flightrec <dump.json>...``: render flight-recorder dumps as
  timelines (stderr) and one JSON summary line (exit 2 when none reads);
- ``autotune slo.ledger_dir=<dir> [trace.dir=<dir>]``: the one-shot
  offline autotuner pass (torch-free): fit the per-entry cost model from
  the ledger shards, search bucket grids against the span history's
  requested rows (the ledger's mean rows per dispatch without spans) and
  print the plan as one JSON line; exit 0 when a regrid is warranted, 3
  when the grid of ``serve.warmup_batch_sizes`` already wins.

Tracing and the SLO layer are armed from the config on both planes:
``trace.enabled=true`` (``MLOPS_TPU_TRACE_ENABLED``; spans into
``trace.dir``), ``slo.enabled=true`` (the SLO engine, the alert gauges,
the ``/healthz`` verdict and the flight recorder into
``slo.flightrec_dir``) and ``slo.ledger_dir=<dir>`` (the cost ledger).
With both tracing and the ledger armed, ``autotune.enabled=true`` runs
the traffic-shape autotuner on either plane: it fits the cost model,
searches the bucket grid every ``autotune.interval_s`` and hot-regrids
the engine (new CUDA graphs captured off the request path, then one
exchange), writing ``<autotune.plan_dir>/plan.json``; on the ring plane
engine replica 0 plans and the other replicas adopt its plan.

``serve --workers N`` (``serve.workers``, ``MLOPS_TPU_SERVE_WORKERS``)
with N >= 2 serves from N ``SO_REUSEPORT`` front-end processes over a
shared-memory ring to one engine process (``serve/frontend.py``); 0 and 1
are the single-process server. ``serve --replicas E``
(``serve.engine_replicas``) runs E engine replica processes behind that
ring. ``serve --tenants <file>`` (``serve.tenants_path``) serves the
tenant fleet a tenants.toml declares (``configs/tenants.toml``) on either
plane, routed by the ``x-tenant`` header; ``serve.model_directory`` is
then not resolved. ``serve.model_shards=S`` splits each engine's params
over S ranks, one card each (gloo ranks with ``serve.device=cpu``): the
serving process, or each ring replica's engine process, is rank 0 and
starts the other S - 1 itself (``serve/shards.py``).

Every command takes ``--config <toml>``, ``MLOPS_TPU_<SECTION>_<FIELD>``
environment overrides and positional ``section.field=value`` overrides,
as the JAX package's CLI does (``serve.model_directory=<bundle>
serve.port=5001 serve.device=cpu``); a key the port has not ported, set
away from its JAX default (``MLOPS_TPU_SERVE_LOOP_LAG_MONITOR=true``),
exits non-zero naming its ROADMAP item. A
``gs://`` ``data.train_path`` or ``registry.root`` is read and written
through ``utils/storage.py``, as in the JAX package.
Every command runs on the card unless ``serve.device=cpu`` (serve,
predict-file, score-batch) or ``train.device=cpu`` (train, pretrain,
tune). For
``serve``, ``MODEL_DIRECTORY`` and ``SERVICE_NAME`` in the environment
take precedence over the config, as in the reference; a model directory
that is not a directory is a registry version, stage or ``latest``
(``serve.model_directory=production``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mlops-tpu-torch",
        description="PyTorch/CUDA port of the credit-default serving path",
    )
    sub = parser.add_subparsers(dest="command")
    commands = {
        "serve": (
            "serve a bundle over HTTP (exact or quant tier; lifecycle.enabled=true "
            "also runs the drift-triggered retrain -> shadow -> gated hot-promotion "
            "loop in-process)",
            "serve.port=5001",
        ),
        "lifecycle": (
            "one-shot offline lifecycle pass: retrain a candidate from the labeled "
            "window (lifecycle.labeled_path), grade it against the incumbent through "
            "the AUC/calibration gates, and register it when it passes",
            "lifecycle.labeled_path=<csv> serve.model_directory=<bundle>",
        ),
        "predict-file": (
            "score a CSV with a flax bundle or a record-history CSV with a doc bundle",
            "data.train_path=<csv> serve.model_directory=<bundle>",
        ),
        "train": (
            "train an exact-tier model or the long-context doc model into a bundle",
            "train.steps=200 registry.root=<dir>",
        ),
        "pretrain": (
            "masked-feature pretraining on unlabeled rows (bert)",
            "model.family=bert train.steps=1000",
        ),
        "score-batch": (
            "bulk-score a dataset (in memory or streamed) with a flax bundle",
            "data.rows=1000000 serve.model_directory=<bundle>",
        ),
        "tune": (
            "hyperparameter search (trials stacked), the winner registered",
            "hpo.trials=10 hpo.strategy=sha registry.root=<dir>",
        ),
        "register": (
            "register a bundle in the model registry",
            "data.train_path=<bundle dir> registry.root=<dir>",
        ),
        "promote": (
            "move a registered version between stages",
            "registry.promote_version=3 registry.promote_stage=production",
        ),
        "versions": ("list registered versions, stages, tags", "registry.root=<dir>"),
        "gc": (
            "prune registry orphans (and old unstaged versions)",
            "registry.gc_keep=5",
        ),
        "synth": ("generate a synthetic schema-conforming CSV", "data.rows=50000"),
        "validate": (
            "schema-check a CSV (OOV / unparseable counts)",
            "data.train_path=<csv>",
        ),
        "warmup": (
            "build the kernel libraries into the cache (cache.dir)",
            "serve.model_directory=<bundle>",
        ),
        "trace-report": (
            "p50/p99 per stage per entry from a traced server's span files "
            "(trace.dir), or the cost ledger ranked (--ledger)",
            "trace.dir=traces",
        ),
        "autotune": (
            "one-shot offline autotuner pass: fit the per-entry dispatch cost model "
            "from the device-time ledger (slo.ledger_dir), search bucket grids "
            "against the observed traffic shape, and print the winning plan "
            "(exit 3 when the current grid already wins)",
            "slo.ledger_dir=<dir> trace.dir=<dir>",
        ),
    }
    for name, (help_text, example) in commands.items():
        cmd = sub.add_parser(name, help=help_text)
        cmd.add_argument(
            "--config", default=None, help="path to a TOML config file"
        )
        cmd.add_argument(
            "overrides", nargs="*", help=f"config overrides, e.g. {example}"
        )
        if name == "warmup":
            cmd.add_argument(
                "--cache-dir", default=None,
                help="cache directory (sugar for cache.dir=<dir>)",
            )
        if name == "serve":
            cmd.add_argument(
                "--workers", type=int, default=None,
                help="HTTP front-end processes (sugar for serve.workers=N): "
                "N >= 2 binds one port from N processes via SO_REUSEPORT, "
                "all feeding one engine process over the shared-memory "
                "ring; 0/1 = single-process server",
            )
            cmd.add_argument(
                "--tenants", default=None,
                help="multi-tenant fleet declaration (sugar for "
                "serve.tenants_path=<file>): a tenants.toml naming N "
                "tenants (name, bundle_dir, quota weight, default "
                "tenant); requests route by the x-tenant header",
            )
            cmd.add_argument(
                "--replicas", type=int, default=None,
                help="engine replica set (sugar for "
                "serve.engine_replicas=E): E engine processes behind the "
                "one shared-memory ring; a kill -9 of one replica is a "
                "brownout of 1/E capacity (needs --workers >= 2)",
            )
        if name == "trace-report":
            cmd.add_argument(
                "--ledger", action="store_true",
                help="report the device-time cost ledger (slo.ledger_dir) "
                "ranked by cost_ms_per_row instead of aggregating span files",
            )
            cmd.add_argument(
                "--tenant", default=None,
                help="only aggregate spans whose tenant label matches",
            )
            cmd.add_argument(
                "--replica", type=int, default=None,
                help="only aggregate spans served by this engine replica "
                "(spans without one count as 0)",
            )
    # `flightrec` takes dump paths, not config overrides: a post-mortem
    # renders anywhere the dump files are.
    flightrec = sub.add_parser(
        "flightrec",
        help="render flight-recorder dumps (flightrec-*.json) as timelines",
    )
    flightrec.add_argument("paths", nargs="+", help="dump files to render")
    return parser


def _serve(config) -> int:
    from mlops_tpu_torch.bundle.registry import resolve_bundle

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = config.serve
    cfg.service_name = os.environ.get("SERVICE_NAME", cfg.service_name)
    model_dir = os.environ.get("MODEL_DIRECTORY", cfg.model_directory)
    cfg.validate()
    config.lifecycle.validate()
    config.autotune.validate()
    if config.autotune.enabled:
        # The JAX cross-section contract, on both planes, before anything
        # warms: the autotuner's demand input is the shape histograms and
        # its cost input the cost ledger, and one tunable grid per plane.
        if not config.trace.enabled:
            raise SystemExit(
                "autotune.enabled requires trace.enabled (the shape "
                "histograms are the demand input)"
            )
        if not config.slo.ledger_dir:
            raise SystemExit(
                "autotune.enabled requires slo.ledger_dir (the cost "
                "ledger is the cost-model input)"
            )
        if cfg.tenants_path:
            raise SystemExit(
                "autotune.enabled supports single-tenant planes only "
                "(the shared shape table cannot attribute demand per "
                "tenant grid)"
            )
    # A tenants file names every bundle itself: the model directory is not
    # resolved on either plane.
    bundle_dir = "" if cfg.tenants_path else str(resolve_bundle(config, model_dir))
    if cfg.workers >= 2:
        # The supervisor stays torch-free: only its engine children load
        # the bundles and touch the device.
        from mlops_tpu_torch.serve.frontend import serve_multi_worker

        return serve_multi_worker(config, bundle_dir)
    from mlops_tpu_torch.ops import cuda_build

    cuda_build.set_cache_dir(config.cache.dir)
    mesh = followers = None
    device = cfg.device
    if cfg.model_shards > 1:
        # One engine over S ranks, one card each: this process is rank 0,
        # the lead; it starts the S - 1 followers, which build every
        # tenant's engine as the lead announces it.
        from mlops_tpu_torch.serve.shards import start_followers

        mesh, followers, world = start_followers(cfg.model_shards, cfg.device)
        device = world.device
    try:
        return _serve_engines(config, bundle_dir, device, mesh)
    finally:
        if followers is not None:
            followers.stop(mesh)


def _serve_engines(config, bundle_dir: str, device, mesh) -> int:
    """The single-process plane's engines (over ``mesh`` when sharded) and
    its server."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.server import serve_forever

    cfg = config.serve
    registry = None
    if cfg.tenants_path:
        # The fleet on the single-process plane: one engine per tenant
        # behind one HTTP server.
        from mlops_tpu_torch.tenancy import TenantRegistry, load_tenants_toml

        try:
            tenancy = load_tenants_toml(cfg.tenants_path).validate()
        except ValueError as err:
            raise SystemExit(str(err)) from err
        registry = TenantRegistry(tenancy, buckets=tuple(cfg.warmup_batch_sizes),
                                  serve_tier=cfg.serve_tier, device=device,
                                  tier_routing=cfg.tier_routing, mesh=mesh)
        engine = registry.default_engine
    else:
        engine = InferenceEngine(
            load_bundle(bundle_dir),
            buckets=tuple(cfg.warmup_batch_sizes),
            serve_tier=cfg.serve_tier,
            device=device,
            tier_routing=cfg.tier_routing,
            mesh=mesh,
        )
    fleet = {} if registry is None else {"registry": registry}
    if config.autotune.enabled:
        # The periodic fit -> search -> hot regrid on the live engine (a
        # single-tenant plane: refused above with a tenants file).
        from mlops_tpu_torch.autotune import AutotuneController

        fleet["autotune"] = AutotuneController(engine, config.autotune)
    # The observability sections ride only when armed.
    if config.trace.enabled:
        fleet["trace"] = config.trace
    if config.slo.enabled or config.slo.ledger_dir:
        fleet["slo"] = config.slo
    if not config.lifecycle.enabled:
        serve_forever(engine, cfg, **fleet)
        return 0
    # The closed loop's controller threads, in this process, one per
    # tenant: each watches its engine's monitor aggregate, retrains off the
    # hot path, shadows, and hot-promotes through the gates.
    from mlops_tpu_torch.lifecycle.controller import LifecycleController

    if registry is None:
        lifecycle = LifecycleController(engine, config)
    else:
        from mlops_tpu_torch.tenancy import tenant_scoped_config

        # A one-tenant "default" fleet keeps lifecycle.dir, as the ring
        # plane does.
        single_default = registry.names == ("default",)
        lifecycle = [
            LifecycleController(eng, config if single_default
                                else tenant_scoped_config(config, name))
            for name, eng in zip(registry.names, registry.engines)
        ]
    serve_forever(engine, cfg, lifecycle=lifecycle, **fleet)
    return 0


def _lifecycle(config) -> int:
    from mlops_tpu_torch.commands import lifecycle

    logging.basicConfig(level=logging.INFO, format="%(message)s")  # stderr
    record, passed = lifecycle(config)
    print(json.dumps(record), flush=True)
    return 0 if passed else 3


def _predict_file(config) -> int:
    from mlops_tpu_torch.commands import predict_file

    print(json.dumps(predict_file(config)), flush=True)
    return 0


def _train(config) -> int:
    from mlops_tpu_torch.commands import train

    print(json.dumps(train(config)), flush=True)
    return 0


def _pretrain(config) -> int:
    from mlops_tpu_torch.commands import pretrain

    print(json.dumps(pretrain(config)), flush=True)
    return 0


def _score_batch(config) -> int:
    from mlops_tpu_torch.commands import score_batch

    print(json.dumps(score_batch(config)), flush=True)
    return 0


def _tune(config) -> int:
    from mlops_tpu_torch.commands import tune

    logging.basicConfig(level=logging.INFO, format="%(message)s")  # stderr
    print(json.dumps(tune(config)), flush=True)
    return 0


def _register(config) -> int:
    from mlops_tpu_torch.commands import register

    print(register(config), flush=True)
    return 0


def _promote(config) -> int:
    from mlops_tpu_torch.commands import promote

    print(json.dumps(promote(config)), flush=True)
    return 0


def _versions(config) -> int:
    from mlops_tpu_torch.commands import versions

    print(json.dumps(versions(config), indent=2), flush=True)
    return 0


def _gc(config) -> int:
    from mlops_tpu_torch.commands import gc

    print(json.dumps(gc(config)), flush=True)
    return 0


def _synth(config) -> int:
    from mlops_tpu_torch.commands import synth

    print(synth(config), flush=True)
    return 0


def _warmup(config) -> int:
    from mlops_tpu_torch.commands import warmup

    print(json.dumps(warmup(config)), flush=True)
    return 0


def _validate(config) -> int:
    from mlops_tpu_torch.commands import validate

    report = validate(config)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 2


def _trace_report(config) -> int:
    """The JAX ``trace-report``: the human table on stderr, the JSON
    report on stdout; exit 2 when nothing was found."""
    if config.trace.ledger:
        from mlops_tpu_torch.slo.ledger import format_ledger_report, ledger_report

        if not config.slo.ledger_dir:
            raise SystemExit(
                "trace-report --ledger needs slo.ledger_dir (the "
                "directory a served plane's cost ledger flushed into)"
            )
        report = ledger_report(config.slo.ledger_dir)
        print(format_ledger_report(report), file=sys.stderr)
        print(json.dumps(report), flush=True)
        return 0 if report["entries"] else 2
    from mlops_tpu_torch.trace import format_report, load_spans, stage_report

    spans = load_spans(config.trace.dir)
    if config.trace.tenant:
        spans = [s for s in spans if s.get("tenant", "default") == config.trace.tenant]
    if config.trace.replica >= 0:
        spans = [s for s in spans if int(s.get("replica", 0)) == config.trace.replica]
    report = stage_report(spans)
    print(format_report(report), file=sys.stderr)
    print(json.dumps(report), flush=True)
    return 0 if spans else 2


def _autotune(config) -> int:
    """The JAX ``autotune``: persisted ledger shards and optional span
    history in, one plan JSON line out. Exit 0 = a regrid is warranted, 3
    = the searched grid does not clear ``autotune.min_gain_pct`` (the plan
    is printed all the same), ``SystemExit`` when the telemetry yields no
    model. Torch-free end to end."""
    from mlops_tpu_torch.autotune.costmodel import demand_from_spans, fit_cost_model
    from mlops_tpu_torch.autotune.search import search_plan
    from mlops_tpu_torch.slo.ledger import ledger_report

    config.autotune.validate()
    if not config.slo.ledger_dir:
        raise SystemExit(
            "autotune needs slo.ledger_dir (the directory a served "
            "plane's cost ledger flushed into)"
        )
    rows = ledger_report(config.slo.ledger_dir).get("entries", [])
    model = fit_cost_model(rows)
    if model is None:
        raise SystemExit(
            "autotune: no solo bucket_N entries in the ledger — serve "
            "traffic with slo.ledger_dir armed first"
        )
    # Demand: the span history's exact requested rows when the trace dir
    # has it, else the ledger's mean rows per dispatch of each bucket.
    demand = []
    if config.trace.dir:
        from mlops_tpu_torch.trace import load_spans

        try:
            demand = demand_from_spans(load_spans(config.trace.dir))
        except OSError:
            demand = []
    if not demand:
        demand = [
            (max(1, int(round(r["rows"] / r["dispatches"]))), float(r["dispatches"]))
            for r in rows
            if str(r.get("entry", "")).startswith("bucket_")
            and float(r.get("dispatches", 0)) > 0
        ]
    if not demand:
        raise SystemExit("autotune: no demand observations")
    plan = search_plan(demand, model, tuple(config.serve.warmup_batch_sizes),
                       config.autotune.max_entries)
    doc = plan.as_dict()
    warranted = (plan.buckets != plan.baseline_buckets
                 and plan.predicted_gain_pct >= config.autotune.min_gain_pct)
    doc["regrid_warranted"] = warranted
    print(json.dumps(doc), flush=True)
    return 0 if warranted else 3


def _flightrec(paths: list[str]) -> int:
    """The JAX ``flightrec``: each dump's timeline on stderr, one JSON
    summary line on stdout; exit 2 when no dump reads."""
    from mlops_tpu_torch.slo.flightrec import format_timeline, load_dump

    summaries = []
    for path in paths:
        try:
            dump = load_dump(path)
        except (OSError, ValueError) as err:
            print(f"flightrec: unreadable dump {path}: {err}", file=sys.stderr)
            continue
        print(format_timeline(dump), file=sys.stderr)
        summaries.append({
            "path": str(path), "reason": dump.get("reason"),
            "source": dump.get("source"), "worker": dump.get("worker"),
            "pid": dump.get("pid"), "events": len(dump.get("events", [])),
        })
    print(json.dumps(summaries), flush=True)
    return 0 if summaries else 2


def main(argv: list[str] | None = None) -> int:
    from mlops_tpu_torch.config import load_config

    args = build_parser().parse_args(argv)
    if args.command == "flightrec":
        return _flightrec(args.paths)
    handlers = {
        "serve": _serve,
        "lifecycle": _lifecycle,
        "predict-file": _predict_file,
        "train": _train,
        "pretrain": _pretrain,
        "score-batch": _score_batch,
        "tune": _tune,
        "register": _register,
        "promote": _promote,
        "versions": _versions,
        "gc": _gc,
        "synth": _synth,
        "validate": _validate,
        "warmup": _warmup,
        "trace-report": _trace_report,
        "autotune": _autotune,
    }
    if args.command not in handlers:
        build_parser().print_help()
        return 1
    overrides = list(args.overrides)
    if getattr(args, "cache_dir", None):
        overrides.append(f"cache.dir={args.cache_dir}")
    if getattr(args, "workers", None) is not None:
        overrides.append(f"serve.workers={args.workers}")
    if getattr(args, "tenants", None):
        overrides.append(f"serve.tenants_path={args.tenants}")
    if getattr(args, "replicas", None) is not None:
        overrides.append(f"serve.engine_replicas={args.replicas}")
    if getattr(args, "ledger", False):
        overrides.append("trace.ledger=true")
    if getattr(args, "tenant", None):
        overrides.append(f"trace.tenant={args.tenant}")
    if getattr(args, "replica", None) is not None:
        overrides.append(f"trace.replica={args.replica}")
    try:
        config = load_config(overrides, args.config)
    except ValueError as err:  # a refused key: its message, no traceback
        raise SystemExit(str(err)) from err
    return handlers[args.command](config)


if __name__ == "__main__":
    sys.exit(main())
