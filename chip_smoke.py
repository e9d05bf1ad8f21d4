#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card of compute capability 9.0 and exits non-zero,
printing no result, without one (or when run from a directory that holds
this script and nothing else of the repository). It imports torch and the
port (``mlops_tpu_torch``), never JAX or the JAX package. Twelve main
paths: quant-tier serving (``POST /predict`` with
``serve.serve_tier=quant``), long-context doc scoring (``predict-file`` on
a ``doc`` bundle), doc-model training (``train --config
configs/long_context_job.toml model.seq_parallel=false``), exact-tier
serving (``POST /predict`` on a ``flax`` bundle, the default tier),
exact-tier training (``train --config configs/train_register_job.toml``),
the distilled students it packages, bulk scoring (``score-batch``, in
memory and streamed), the deployed training Job (``tune``, then
``promote`` and ``serve`` of the registry's production stage), on local
paths and, as ``kubernetes/train-job.yml`` runs it, on a ``gs://`` bucket,
serving as the serving image starts it (``warmup --cache-dir``, then
``serve`` on the multi-worker ring plane), and the closed lifecycle loop
(``serve --config configs/lifecycle_serve.toml``: drift trigger, retrain,
shadow, gated hot swap, rollback), in one process and on the ring plane,
also under a seeded fault plan, and the serving plane scaled out and
shared: an engine replica set behind one ring (``serve --replicas 2``)
and a tenant fleet (``serve --tenants configs/tenants.toml``) with its
quotas and per-tenant loops; and the rest of the transformer families:
the moe family trained and served, masked-feature ``pretrain`` then a
``train.init_params`` fine-tune at BERT-base width, and an ensemble of
transformer members served; and the multi-rank layouts at world size 1
over NCCL (tensor- and pipeline-parallel ``train``, ``tune`` and
``score-batch`` under ``torch.distributed.run``).
Phases, each of which fails the run loudly:

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions,
   compute capability;
2. build every kernel source of ``mlops_tpu_torch/csrc`` (one nvcc per
   source, all started together), printing the build times and ptxas'
   register/spill/shared-memory summary;
3. a full-width quant bundle without JAX: 20,000 synthetic rows, the
   preprocessor and monitor fits (R=2048), seeded int8/bf16 student
   weights (E=4, H=32), written in the bundle format;
4. the kernel against its plain PyTorch version on the card, at solo
   buckets 1/8/64/256 with partial masks and at all 12 group geometries
   with all-padding slots, then on K-S edge cases (ties with the
   reference and within a slot, values past both ends of the reference,
   a one-row and an all-padding slot; B = 1..300, S = 1, 3, 4, 64):
   counts and K-S statistics exact, predictions within 1e-6, flags exact
   except rows within 1e-5 x threshold of it, two launches bitwise equal;
5. the main path: ``python -m mlops_tpu_torch serve
   serve.serve_tier=quant`` in a subprocess
   answers the golden request and 5/64/256-record bodies (257 -> 413,
   malformed -> 422), the engine's grouped path runs a 64x1 and a 64x8
   group in this process; responses agree with the plain version run on
   the CPU, /metrics rows equal the records sent, the kernel's launch
   count rose, and SIGTERM drains the server;
6. timing at bucket 1, bucket 256 and groups 64x1 and 64x8: the
   kernel's device time (100 launches captured in a CUDA graph and
   replayed between events; beside it ``torch.profiler``'s kernel time),
   the same for an empty launch of the same grid made the same way, the
   host-paced time (events around back-to-back ctypes calls, which the
   host's submission decides once the kernel is shorter than it), the
   wrapper, the plain version, whole dispatch -> fetch, and the bound
   from bytes and operations;
7. the flash-attention kernel against its plain version on the card: the
   doc model's full width (256, 508, 8, 32) bf16 as views of one qkv
   projection, doc_records 3 (4, 140, 2, 16), ragged (2, 200, 4, 64) in
   f32 and bf16, cross-length q 45 / kv 70 in f32, head_dim 8 and 128 in
   f32, and in bf16 at the tile edges (S = 127, 128, 129, 255, 256, 257,
   508 and q/kv 45/70, 70/45 at head_dim 8, 16, 32, 64 and 128); f32 out
   2e-5 and lse 1e-5, bf16 out 2e-2 and lse 1e-3; one launch per call;
8. the doc path at full width: a bundle of the ``long_context_job.toml``
   model (bert, doc_records 11, token_dim 256, depth 4, heads 8, bf16)
   with seeded weights, preprocessor and monitor fitted on 20,000
   synthetic rows; ``python -m mlops_tpu_torch predict-file`` on a
   300*11 + 7-row history CSV at ``serve.max_batch=128`` in a
   subprocess, then the same function in this process (equal output,
   flash launches = depth x chunks = 12), checked against the same
   forward with dense attention on the card and against the port on the
   CPU for the first 16 documents (1e-2 on probabilities);
9. flash timing at full width: the kernel's launch on preallocated
   outputs, the wrapper, the plain version, SDPA as the
   library yardstick, the bound (bytes, tensor-core FLOPs, exponentials),
   and end to end: documents/s of doc scoring at ``max_batch=256`` over
   1,024 documents, forward ms per chunk and the kernel's share of it;
10. the two flash backward kernels (dq; dk and dv) against their plain
    version on the card: the training shape (64, 508, 8, 32) bf16 as
    views of one qkv projection, (4, 140, 2, 16) bf16 and f32, ragged
    (2, 200, 4, 64) f32 and bf16, cross-length q 45 / kv 70 f32, head_dim
    8 and 128 in f32, the bf16 tile edges of phase 7 (S = 508 included)
    at every head_dim; f32
    within 5e-5 + 1e-4 x the gradient's largest magnitude, bf16 within
    two bf16 ulps of it; one launch of each per call; two dq launches at
    the training shape bitwise equal;
11. training at full width in this process (the job's model, batch 64,
    bf16, one seeded init): one step's gradients through the flash
    kernels against dense attention, parameter by parameter (cosine
    >= 0.98, norm ratio within 5 %); then 30 steps each way on the same
    batches: loss curves within 0.05 of each other (0.02 on average),
    the flash run's loss falls (mean of the last 10 below the first 10),
    and every step launches exactly depth forwards, depth dq and depth
    dk/dv kernels;
12. the training main path: ``python -m mlops_tpu_torch train --config
    configs/long_context_job.toml model.seq_parallel=false`` in a
    subprocess with ``train.steps`` and ``train.eval_every`` cut (logged;
    widths and rows are the job's), its JSON checked (finite metrics,
    metrics.jsonl, a ``doc`` bundle), the port's ``predict-file`` on the
    bundle it wrote; then the same command's function in this process
    with the launch counts set to 0 just before: dq and dk/dv exactly
    steps x depth, forwards steps x depth plus depth per evaluation
    chunk;
13. training timing: step ms (CUDA events, after warm-up) and documents
    trained per second; each backward kernel's ms beside its bound, the
    plain version's ms and SDPA's backward ms (the library yardstick for
    the pair), and the share of a step the three attention kernels take;
14. head_dim 8 and 128 in training (ROADMAP C1): the doc model at the
    config's default width (token_dim 64 over 8 heads: head_dim 8, depth
    3) and at token_dim 256 over 2 heads (head_dim 128, depth 2), batch
    64, 508 tokens: 5 steps each through the flash kernels and through
    dense attention on the same batches (every step launches depth
    forwards, dq and dk/dv; losses finite, within 0.05); then each
    kernel's time at both head dims beside its bound, its plain version
    and the library yardsticks (SDPA's forward, its backward op);
15. ``quant_fused`` past its old shared-memory layout (ROADMAP C2): a
    monitor fitted with drift_ref_size 32,768 (its planes read from
    global memory) at 1x256 and 64x8, and 17,408 rows per slot at
    R = 2048 (sorted through the global workspace), with K-S edge inputs:
    counts and K-S exact, then each shape's device time (graph replay, as
    phase 6) beside an empty launch of its grid, the wrapper, the plain
    version and its bound;
16. the exact tier (no kernel of its own): seeded full-width ``flax``
    bundles of ``linear``, ``mlp`` and ``mlp-ens8`` (hidden 256/256/128,
    embed 16, 8 members, bf16), written by the port; each model's packed
    programs on the card against the port's CPU route at every bucket
    and group geometry (predictions within 1.6e-2: four bf16 ulps of a
    logit times the sigmoid's slope; flags exact off the threshold band;
    K-S statistics, category counts and accumulator counters exact;
    drift within 1e-5);
17. the exact main path: ``python -m mlops_tpu_torch serve`` (the default
    tier) on the mlp-ens8 bundle answers the golden request and 5/64/256
    bodies like the CPU route and drains on SIGTERM, launching no
    kernel; ``predict-file`` on it, card against CPU; dispatch -> fetch
    p50 of each model at bucket 1, bucket 256 and groups 64x1, 64x8;
18. exact-tier training, card against CPU (no kernel of its own): mlp
    (hidden 256/256/128, embed 16), mlp-ens8, ft_transformer and bert
    (token_dim 64, depth 3, 8 heads; BERT reads 48 tokens) and linear at
    the config's widths, bf16, dropout 0, one seeded init on both: one
    step's gradients leaf by leaf (cosine >= 0.98, norm ratio within
    5 %), then 25 steps each way on the same batches of 64 rows (loss
    curves within 0.05, 0.02 on average);
19. the exact tier's training main path: ``python -m mlops_tpu_torch
    train --config configs/train_register_job.toml`` in a subprocess at
    the job's full config (mlp, 50,000 rows, batch 1024, 2,000 steps,
    pos_weight 3, bf16), then mlp-ens8 (``train.distill_bulk=false``),
    ft_transformer and bert with the steps cut to 200, eval every 100
    (logged; widths the config's): each JSON line checked (finite metrics, one metrics.jsonl
    row per window, the packaged step the best AUC's), each bundle on the
    card against the CPU route at every bucket and group geometry
    (phase 16's tolerances) and over HTTP (the golden request, no kernel
    launched); then ``fit`` of the mlp config in this process for 100
    steps on the card and on the CPU on the same batches, validation AUCs
    within 0.01, no kernel launched (the counts set to 0 just before);
20. exact-tier training timing per family at batch 1024: step ms (CUDA
    events over 4 windows of 15 steps after warm-up: the median window,
    with the fastest and slowest beside it), rows trained per second,
    device kernels per step and the device's busy share of an unprofiled
    step (``torch.profiler``), and the CLI's wall time;
21. eager against CUDA-graph dispatch (the engines serve every program
    from a graph captured at warmup; ``cuda_graphs=False`` runs the same
    programs eagerly): for the quant tier and the linear, mlp and
    mlp-ens8 exact tiers at bucket 1, bucket 256 and groups 64x1, 64x8,
    the two routes' fetched arrays bitwise equal, then in turns
    dispatch -> fetch p50/p99 with the spread of the turns, and under
    ``torch.profiler`` the host's CUDA API calls (kernel and graph
    launches), device ops and the device's busy share per dispatch;
    each engine's capture seconds and graph pool bytes;
22. concurrent traffic, the serving main path under load: ``python -m
    mlops_tpu_torch serve serve.tier_routing=true`` on the mlp-ens8
    bundle with a gated quant student, once as configured (the
    micro-batcher on) and once with ``serve.batch_window_ms=0``, each
    taking 600 single-record and 600 mixed 1..8-record requests at
    1, 16 and 64 keep-alive connections (every fourth request asks for
    ``x-slo-class: cheap``, the quant tier): every answer held against
    the CPU route (phase 5 and 16 tolerances), /metrics rows equal to the
    records sent, the quant_fused launches equal to the quant-tier
    dispatches (graph replays), fewer dispatches than requests at
    concurrency 64 with the batcher on; requests/s, p50/p99 and
    dispatches (grouped ones too) per request.

23. the distilled students, the main path of packaging: ``python -m
    mlops_tpu_torch train --config configs/train_register_job.toml`` with
    ``model.ensemble_size=8 train.distill_quant=true``, the same at
    ``train.pos_weight=1.0`` (the package default), and
    ``model.family=ft_transformer``, ``train.distill_bulk`` at its default
    (true), steps cut to 200, in three concurrent subprocesses: each
    bundle's ``bulk`` block (fidelity: mean |Δprob| <= 0.05, |AUC delta|
    <= 0.02) and the ensembles' ``quant`` block with its gate record; an
    ungated quant tier refused by the engine; each student's fit seconds
    (800 steps) and device ops and kernel launches per step; the gated
    port-trained quant tier served as phase 5 serves (``serve
    serve.serve_tier=quant``, four bodies and two groups against the CPU
    route, ``quant_fused`` launches counted at replay);
24. bulk scoring, the main path: ``python -m mlops_tpu_torch score-batch
    data.rows=1000000`` on phase 23's mlp-ens8 bundle in a subprocess (the
    exact path on the card), then ``score_dataset`` at 1,000,000 rows on
    its exact and distilled paths, the gated quant path, and the
    ft_transformer bundle at 262,144 rows, chunk 131,072: depth 1 and
    depth 2 bitwise equal, the first chunk's first 32,768 rows against the
    CPU route (1.6e-2; the quant path 1e-6; flags exact off the band) and the
    drift on the same 65,536-row sample (1e-5), rows/s, the stage
    record, peak device memory, and device ops and busy share per chunk
    (``torch.profiler`` over two chunks);
25. streamed bulk scoring: a 200,000-row synthetic CSV through ``python
    -m mlops_tpu_torch score-batch score.streaming=true
    score.output_path=...`` in a subprocess; every output row equal to
    the in-memory path's prediction rounded to 6 places and its flag;
    rows/s and the stage record;
26. the deployed training Job on local paths: ``python -m mlops_tpu_torch
    tune --config configs/train_register_job.toml`` in a subprocess at the
    job's full config (10 trials x 1,000 steps of the mlp, hidden
    256/256/128, embed 16, bf16, 50,000 rows, batch 1024): its JSON line,
    trials.jsonl, best.json and the registered bundle (calibrated, no quant
    tier); in this process, the counts set to 0 just before, the
    job's stacked step at 10 trials and at 2 (step ms as phase 20, trial
    rows per second, kernels and busy share per step, peak device memory;
    kernels per step at 10 within 10 % of 2), no kernel launched; the
    stacked trainer on the card against its CPU route at the job's width,
    3 trials x 20 steps from the same init, rows and masks (per-trial
    gradient cosine >= 0.98, loss curves within 0.05);
27. the architecture sweep: ``tune --config configs/tune_architectures.toml
    hpo.strategy=sha`` with the steps cut 1,000 -> 50 (widths the
    config's: mlp 128x128 embed 8, mlp 256x256x128 embed 16,
    ft_transformer token_dim 64 depth 3; 8 trials a group), each record
    with its group, architecture, rung and steps, the winner's bundle
    with its bulk student when an ensemble or a transformer wins; the
    same command again under the same run name restores every group
    (none retrained, the same best.json, a new version); each group's
    stacked step at 8 trials timed as phase 26;
28. the deployed Job as the manifest runs it: the job config's 50,000
    synthetic rows as a CSV uploaded to a fake bucket (``FileBucket``:
    objects are files under ``build/``, every subprocess runs the CLI
    through ``gcs_main`` with the port's GCS client speaking to it; the
    card machine has no network), then exactly the manifest's argv,
    ``tune --config configs/train_register_job.toml
    data.train_path=gs://.../curated.csv registry.root=gs://.../registry
    registry.run_name=train-job``, on the card; ``promote`` of its winner
    to production on the bucket; ``serve serve.model_directory=production
    registry.root=gs://...`` with ``MLOPS_TPU_SERVE_WORKERS=0`` and the
    port through ``MLOPS_TPU_SERVE_PORT``, four bodies against the CPU
    route on the bundle the registry downloads (1.6e-2), and at once the
    same ``serve`` with ``MLOPS_TPU_SERVE_WORKERS=2`` and
    ``MLOPS_TPU_CACHE_DIR`` set (the ring plane, answering the same); the
    same ``serve`` with ``MLOPS_TPU_SERVE_LOOP_LAG_SLOW_MS=0`` (a
    non-zero exit with the JAX package's validation message), a
    ``train`` at 50 steps with ``train.tensorboard_dir`` (event files, or
    the JAX warning where ``torch.utils.tensorboard`` is unusable), and
    where pyarrow imports ``score-batch`` on ``gs://.../rows.parquet``
    against the same rows as the CSV (equal to 6 places); the Job's wall
    and sweep beside phase 26's, the seconds staging the data and moving
    the bundle, the bucket's objects and bytes;
29. the serving image's start (``docker/Dockerfile:38-55``): ``warmup
    --cache-dir`` into an empty cache (one nvcc, ``quant_fused``) and again
    (reused, none); then ``serve`` with the image's environment
    (``MODEL_DIRECTORY``, ``SERVICE_NAME``, ``MLOPS_TPU_SERVE_WORKERS=2``,
    ``MLOPS_TPU_CACHE_DIR``) and tier routing on phase 22's bundle (the
    ring plane: two front ends over the shared-memory ring to one engine
    process, which builds no kernel and is the plane's only process
    holding the card), beside the same with ``MLOPS_TPU_SERVE_WORKERS=0``;
    phase 22's bursts at 400 requests to both in turns (the first 250 of
    each at one connection), every answer against the CPU route,
    /metrics rows equal to the records sent, ``quant_fused`` launches (read
    from the ring's /metrics, counted in the engine process) equal to the
    quant-tier dispatches, requests/s, p50/p99 and dispatches per request;
    kill -9 of the engine while 16 connections stream 300 requests (every
    answer right, the slots it left busy replayed, kill -> ready timed, no
    nvcc, the respawned engine's answers bitwise equal to its
    predecessor's), again with the cache emptied (one nvcc), kill -9 of a
    front end (respawn timed), SIGTERM while traffic flows (every answer
    200, every process exits 0);
30. the closed lifecycle loop as ``configs/lifecycle_serve.toml`` ships it
    (the single-process plane, tier routing on phase 22's bundle as the
    incumbent; only the loop's clocks overridden: ``tick_s`` 0.25,
    ``cooldown_s`` 2, ``min_window_rows`` 32, ``mirror_fraction`` 1.0): a
    8,000-row labeled window (numerics x10); ``serve --config ...`` in a
    subprocess under four keep-alive clients (single records and 8-record
    bodies, every fourth cheap, each pausing 50 ms between requests; the
    retrain cut to 75 steps), normal traffic and then drifted, until
    the trigger, the retrain on the controller thread, the shadow and the
    promotion to generation 2 show in the log and on /metrics; every
    answer 200, /metrics rows equal to the records answered, p50/p99 in
    four windows (before the trigger, retrain, shadow, after the swap),
    ``quant_fused`` launches in each (0 after the swap: the candidate has
    no quant tier), SIGTERM drains; then in this process the engine and
    ``LifecycleController`` on the same bundle and window, ``run_once``
    driven to a promotion and ``controller.rollback()``: the candidate's
    holdout predictions on the card against the CPU route (1.6e-2), a
    row's answer after the swap bitwise equal to the candidate's eager
    route and after the rollback to the incumbent's (both tiers), the live
    aggregate's rows equal to the rows served across both, ``quant_fused``
    launched before the swap, not after it, once after the rollback; the
    retrain's wall and step ms, the shadow's warm, the swap's and the
    rollback's critical sections in µs, the gate record and peak device
    memory with the graph pools alive;
31. the lifecycle loop on the ring plane as the serving image starts it
    with ``configs/lifecycle_serve.toml`` mounted (``MLOPS_TPU_SERVE_WORKERS=2``
    and ``MLOPS_TPU_CACHE_DIR`` win over the file's ``workers = 0``; the
    loop runs in the engine process, the only one holding the card, with no
    nvcc): phase 30's bundle, window, clocks and four unpaced clients, the
    retrain cut to 75 steps; 32
    requests one at a time before the traffic; per window (before the
    trigger, retrain, shadow, after the swap) p50 / p99, requests/s,
    non-200 and ``quant_fused`` launches from the ring's /metrics; trigger
    -> swap, the retrain's wall and ms per step, the shadow's warm; every
    front end's lifecycle block equal at generation 2; kill -9 of the
    engine: no counter goes back, the respawn serves generation 1 (the
    fork-time bundle, as the JAX plane does) and answers the 32 requests
    bitwise as before the trigger, ``quant_fused`` launching again;
    SIGTERM under traffic, every child exiting 0;
32. a card twin of ``scripts/chaos_smoke.py``: phase 31's plane armed
    through ``MLOPS_TPU_FAULTS`` with ``CHAOS_PLAN`` (the JAX plan format):
    budgeted requests answer 504 inside their deadline while the first
    dispatches stall, 200 after; two injected retrain failures open the
    breaker on every front end and no retrain runs; the engine kills
    itself at main-loop tick 60, the respawn answers bitwise as before and
    no counter goes back; in subprocesses, kills at the reservoir's, the
    atomic write's and the kernel cache's mid-write points leave no torn
    file, and bit flips on the cached library's read are a counted discard
    and one nvcc rebuild whose kernel agrees with its plain version; every
    status in {200, 413, 422, 503, 504}, SIGTERM drains;
33. the engine replica set as the serving image starts it: ``serve
    --workers W --replicas 2`` beside ``--replicas 1`` (W = 4 with eight
    cores, else 2) on phase 22's bundle and phase 29's warmed cache:
    replica 1 ready without nvcc, the two replica processes and only they
    holding the card; phase 29's bursts at 16 and 64 connections on both,
    every answer against the CPU route, requests/s, p50/p99, dispatches
    per request, CPU cores per front end and replica, rows per replica,
    ``quant_fused`` launches summed over the replicas; kill -9 of replica
    1 under 64 connections (every answer 200 and right, replica 0's
    incarnation unchanged, replica 1's up by one, per-replica counters
    monotone), then of replica 0 at rest with 64 requests one at a time
    through the respawned replica 1, bitwise as before; SIGTERM, every
    child exiting 0; ``--replicas 2 lifecycle.enabled=true`` refused with
    the JAX package's message;
34. the tenant fleet of ``configs/tenants.toml`` (its names, order,
    weights and default; emea phase 22's bundle, apac its twin from other
    seeds, latam-ab-arm phase 17's mlp) with its bundle directories
    replaced, on ``serve --tenants`` and on ``serve --tenants --workers W
    --replicas 2``: each tenant's answers bitwise the same bundle's served
    alone on the card, untagged requests emea's, an unknown tenant 404;
    apac on 10x the connections shedding 503s against its own quota, the
    cold tenants never; kill -9 of replica 1 under every tenant's traffic,
    each answer its own tenant's; then the per-tenant loops (``--config
    configs/lifecycle_serve.toml --tenants ... --replicas 1``, phase 30's
    clocks, window and paced clients, the retrain cut to 40 steps):
    drifted traffic to
    latam-ab-arm alone promotes it alone to generation 2, every front end
    rendering each tenant's lifecycle block;
35. the observability layer on the ring plane as the image starts it
    (``--workers 2 --replicas 2``, phase 22's bundle, phase 29's cache)
    armed through ``MLOPS_TPU_TRACE_*``, ``MLOPS_TPU_SLO_*`` (short burn
    windows, the ledger, the flight recorder), ``serve.profile_dir`` and a
    seeded fault plan, beside the same plane disarmed: the plan's failed
    grouped dispatches page (``mlops_tpu_alert_active`` 1, ``/healthz``
    degraded, a dump ``flightrec`` renders); phase 29's single-record
    burst at 16 and 64 connections on both planes in one turn (every
    answer against the CPU route, requests/s armed against disarmed,
    ``quant_fused`` launches equal to quant-tier dispatches);
    the loop-lag sanitizer armed on the armed plane's front ends
    (``MLOPS_TPU_SERVE_LOOP_LAG_MONITOR=true``): after every burst each
    front end's ``mlops_tpu_event_loop_lag_ms`` finite and >= 0, the
    disarmed plane's 0.0, ``quant_fused`` launched over the armed bursts;
    ``trace-report`` per entry and per replica (every 200's span
    stitched, drops read from ``/metrics``); ``/debug/profile`` through a
    front end (200 / 409 / 200 / 409, the trace's ``quant_fused`` kernel
    and graph-launch events); kill -9 of replica 0 at rest with the cost
    ledger's counts carried by the respawn and ``trace-report --ledger``;
    in process, the degraded-bucket fallback on the quant tier bitwise
    the warmed answers and counted; SIGTERM, every child exiting 0;
36. the traffic-shape autotuner on the ring plane as the image starts it
    (``--workers 2 --replicas 2``, phase 22's bundle on its quant tier,
    phase 29's cache, the shipped grid 1, 8, 64, 256) armed through
    ``MLOPS_TPU_TRACE_*``, ``MLOPS_TPU_SLO_LEDGER_DIR`` and
    ``MLOPS_TPU_AUTOTUNE_*`` (interval 2 s, cooldown 30 s, 200
    dispatches, gain floor 0): skewed traffic (85 % of requests 2-3
    records) at 16 connections until the lead replica applies a plan and
    the sibling adopts it, every answer against the CPU route; the plan
    keeps 256, ``mlops_tpu_grid_generation`` 2, a 3-record probe the same
    bytes before and after, dispatched through a bucket the plan added
    with one ``quant_fused`` launch each; each replica's regrid record,
    the predicted and measured gains, requests/s per round before and
    after; ``autotune`` on the flushed ledger and spans; a kill at
    ``autotune.regrid.midswap`` in a subprocess, then a fresh process on
    the same bundle and cache: the old grid, the regrid and its rollback,
    the probe bitwise each time.
37. the gbm tier (the sklearn floor's HistGBM ensemble as a tensor
    program) at the job's full width: the trees of
    ``tests/fixtures/torch_gbm/job_gbm.npz`` (``configs/train_register_job.toml``
    with ``model.family=gbm``: 75 trees of 61 nodes, depth 8, written by
    ``scripts/torch_gbm_fixture.py``) in a bundle built here with the
    preprocessor and monitor the port fits from its synthetic data at the
    job's seed, without scikit-learn or joblib (``sys.modules`` holds
    neither at the end). The engine on the card (f64 tree tensors and
    temperature, one CUDA graph per bucket and group geometry) on the
    fixture's 2,048 validation rows at buckets 1, 8, 64, 256 and groups
    64x1 and 64x8: predictions bitwise equal to scikit-learn's recorded
    tempered probabilities, flags exact and drift within 1e-5 of the
    port's CPU route, counts and K-S exact, the accumulators' counters
    exact; every dispatch a graph replay (``gbm_graph_replays`` set to 0
    before, equal to the dispatches after). Device us per replay by CUDA
    events and kernels per replay by ``torch.profiler`` at 1x1, 1x256,
    64x1 and 64x8, dispatch -> fetch p50, tree-tensor and graph-pool
    bytes; then ``serve`` on the bundle with the image's environment,
    single-process and on the ring plane (``MLOPS_TPU_SERVE_WORKERS=2``):
    single-record requests at 16 and 64 connections, every answer 200 and
    equal to the engine's (predictions and flags bitwise, drift within
    1e-5), requests/s; SIGTERM, both planes exit 0;
38. the rest of the transformer families (after phase 28, beside phases
    29-37): ``train --config configs/train_register_job.toml
    model.family=moe`` (the ModelConfig defaults: token_dim 64, depth 3,
    8 heads, 8 experts; 200 steps, with its bulk student) and ``pretrain
    --config configs/train_register_job.toml`` at BERT-base (hidden 768,
    depth 12, 12 heads; 40 steps at lr 3e-4, the loss curve falling)
    start at once; meanwhile the moe at full width on the card against
    the CPU (eval probabilities 1.6e-2, the auxiliary 1e-3 relative,
    gradients leaf by leaf at cosine 0.98 / norm 5 %, block 0's routes
    exact off near-ties), one stacked ``tune`` step of it at T = 2 card
    against CPU, and a seeded 4-member FT-Transformer ensemble bundle;
    then ``train ... train.init_params=<pretrained.msgpack>`` at
    BERT-base (40 steps), the grafted trunk bitwise the file's and
    ``pooler``/``head`` the fresh init's; the moe, BERT-base and ensemble
    bundles on the card against the CPU route at 1x1, 1x256, 64x1 and
    64x8 and served over HTTP (the golden request; the moe's and the
    ensemble's while the fine-tune trains); the pretrain and
    fine-tune steps timed (step ms, kernels per step, busy share, peak
    device memory) and each bundle's warmup (graphs, capture seconds,
    graph pool bytes) and dispatch -> fetch p50. None of the four
    kernels runs on these paths: their counts read 0;
39. multi-rank training and scoring at world size 1 over NCCL (in the
    second process, after phase 37; the script needs one H100, and NCCL
    refuses two ranks on one device): under ``python -m torch.distributed.run --standalone
    --nproc-per-node 1``, ``train --config configs/train_register_job.toml
    model.tensor_parallel=1`` (the mlp job, 200 of 2,000 steps), bert and
    ft_transformer with ``model.pipeline_stages=1 model.dropout=0`` (50
    steps, 8 microbatches) and ``tune`` beside a plain ``tune``; in this
    process (a one-rank NCCL group from a local store): the TP step of
    mlp, ft_transformer, bert and moe (the ModelConfig defaults) held bit
    for bit against the dense trainer over 50 steps, losses and every
    parameter, each trained through ``run_layout_training``; GPipe held
    against the dense trainer (one step's gradients at cosine 0.98 / norm
    5 %, 50-step curves within 0.05) and the same GPipe run on the CPU
    (a gloo mesh beside the NCCL world) against the card (5 steps' losses
    within 0.05, validation AUC within 0.01); every TP and PP bundle
    served over HTTP on the exact tier (the golden request) while
    ``score-batch`` runs under the launcher beside a plain one (equal
    predictions and flags, ``devices`` 1, ``mesh`` [1]); last, one TP step
    under ``torch.profiler``: its NCCL calls (the ``nccl:*`` host records:
    one all-reduce per gradient leaf at least) and the device kernels and
    copies they ran, and the TP and dense steps' ms. None of the four
    kernels runs here: their counts read 0. ``chip_smoke.py --a11`` runs
    phases 1 and 39 alone.
41. the tooling (in the second process, after phase 39): ``analyze
    --strict --concurrency --contracts --async --fail-stale --no-trace
    mlops_tpu_torch/`` timed in a subprocess (exit 0), then Layer 2 with
    every registered program traced on fake CUDA tensors (no finding; the
    launch counters unchanged across it); ``utils/debug.checked`` around
    the quant and exact packed programs of phase 22's bundle at 1x1,
    1x256 and 64x8 (outputs bitwise the unchecked call's, ``quant_fused``
    launched inside it, a NaN planted in one numeric raising an error
    that names the op, the ms ``checked`` adds); ``utils/flops``:
    ``peak_flops`` for the card's name, the measured bf16 GEMM rate as a
    share of it, the ``FlopCounterMode`` count of the mlp-ens8 forward
    (256 rows) equal to its analytic 2*M*N*K.

Every serving engine on the card dispatches through CUDA graphs, so the
kernel's launches on the main path (phase 5) are counted at graph replay.

Phases 1-15 run alone, so every kernel time of the kernels line is taken
on an otherwise idle card. Once the bundles of phases 16 and 22 are
written, phases 29-37 (the serving planes), 39 and 41 run in a second process
of this script (``--ring-phases``) beside phases 16-28 and 38 in this
one: each
side counts its kernel launches in its own process, and the two share
the card and the host's cores, which their requests/s and step times
show.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import http.client
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from pathlib import Path

from mlops_tpu_torch.utils.flops import BF16_TC_FLOPS, F32_OPS_PER_S, HBM_BYTES_PER_S

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# The published H100 SXM peaks come from mlops_tpu_torch/utils/flops.py's
# table (NVIDIA data sheet): HBM bandwidth, f32 outside the tensor cores
# (132 SMs x 128 lanes x 2 x 1.98 GHz), dense bf16 on the tensor cores.
# Exponentials: 16 per SM per clock on the special-function units, at the
# same 1.98 GHz maximum boost clock as the f32 peak.
EXP_OPS_PER_S = 16 * 132 * 1.98e9

FLASH_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}
DOC_PRED_ATOL = 1e-2  # bf16 model: flash vs dense attention, card vs CPU
DOC_DEPTH = 4
JOB_TOML = "configs/long_context_job.toml"

# Flash vs dense attention in training (bf16): per parameter, the cosine
# of the two gradients and the ratio of their norms; the loss curves'
# largest and mean gap. The dense reference rounds its scores to bf16,
# the kernels keep them in f32, so the two differ by bf16 noise.
GRAD_COSINE_MIN = 0.98
GRAD_NORM_RTOL = 0.05
CURVE_MAX_GAP = 0.05
CURVE_MEAN_GAP = 0.02
# Phase 14's five steps from init: about ten times the largest gap measured
# there (5.2e-4 at head_dim 8, 2.7e-4 at 128; H100 80GB HBM3, 700 W).
C1_CURVE_MAX_GAP = 5e-3
TRAIN_STEPS_CUT = 40  # of the job's 2,000
TRAIN_EVAL_EVERY_CUT = 20  # of the job's 200

PRED_ATOL = 1e-6  # f32 MLP in another summation order + sigmoid
DRIFT_ATOL = 1e-5  # chi2/K-S p-values computed on two devices
FLAG_BAND = 1e-5  # flags may differ only within this fraction of the threshold


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ phase 1
@functools.cache
def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    every timing line carries it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def timed(phase, *args, **kwargs):
    """Run one phase and log its wall time (the run's limit is the sum)."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def log_timing(label: str, row: dict) -> None:
    log(f"{label} {json.dumps({'card': card_line(), **row})}")


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    log(card_line())
    cap = torch.cuda.get_device_capability(0)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {cap}"
    )
    check(cap == (9, 0), f"need compute capability 9.0, got {cap}")
    _no_tf32()


def _no_tf32() -> None:
    """f32 products in f32 in this process, for the card-vs-CPU checks."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ phase 2
def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from mlops_tpu_torch.ops import attention, quant_kernel
    from mlops_tpu_torch.ops.cuda_build import build_shared_library

    sources = {
        "quant_fused": quant_kernel.KERNEL_SOURCE,
        "flash_attention": attention.KERNEL_SOURCE,
        "flash_attention_bwd": attention.BWD_KERNEL_SOURCE,
    }
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {
            name: pool.submit(build_shared_library, source, name)
            for name, source in sources.items()
        }
        results = {name: f.result() for name, f in futures.items()}
    for name, result in results.items():
        log(
            f"build {name}: {result.path.name} in {result.seconds:.2f} s"
            + (" (reused)" if result.reused else "")
        )
        for line in result.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    quant_kernel.load_library()
    attention.load_library()
    attention.load_bwd_library()


# ------------------------------------------------------------------ phase 3
def phase_bundle(seed: int = 0) -> Path:
    from mlops_tpu_torch.bundle import save_quant_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=2048)
    qparams = quantize_student(init_quant_master(seed))
    directory = WORK / "bundle"
    shutil.rmtree(directory, ignore_errors=True)
    save_quant_bundle(
        directory, prep, monitor, qparams, temperature=1.0,
        gates={
            "passed": True,
            "note": "seeded weights, not distilled: this bundle checks "
            "parity, not quality",
        },
        tags={"source": "chip_smoke.py"},
    )
    log(f"bundle: {directory} (R={monitor.num_ref_sorted.shape[1]})")
    return directory


# ------------------------------------------------------------------ phase 4
def _records(n: int, seed: int, drift: float = 0.0) -> list[dict]:
    from mlops_tpu_torch.data import generate_synthetic

    columns, _ = generate_synthetic(n, seed=seed, drift=drift)
    names = list(columns)
    return [{k: columns[k][i] for k in names} for i in range(n)]


def _core_args(state, cat, num, mask):
    qp, mon, temp = state
    return (
        qp["embed"], qp["w1_q"], qp["w1_s"], qp["b1"], qp["w2_q"],
        qp["w2_s"], qp["b2"], mon.num_ref_sorted, mon.num_ref_cdf,
        mon.out_mean, mon.out_precision, mon.out_threshold, temp,
        cat, num, mask,
    )


def _geometries():
    from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS

    shapes = [(1, b) for b in (1, 8, 64, 256)]
    shapes += [(s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS]
    return shapes


def _inputs(prep, s: int, b: int, seed: int, device):
    """Encoded synthetic rows as [S, B, ...] tensors with a partial mask:
    solo buckets drop a quarter of their rows; groups fill slots with
    1..B rows and leave the last slot(s) all padding."""
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    ds = prep.encode(records_to_columns(_records(s * b, seed, drift=0.3)))
    cat = ds.cat_ids.reshape(s, b, -1)
    num = ds.numeric.reshape(s, b, -1)
    rng = np.random.default_rng(seed)
    mask = np.zeros((s, b), bool)
    if s == 1:
        mask[0, : max(1, b - b // 4)] = True
    else:
        for i in range(max(1, s - max(1, s // 4))):
            mask[i, : rng.integers(1, b + 1)] = True
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (cat, num, mask)
    )


def _ks_edge_inputs(prep, ref_sorted, s: int, b: int, seed: int, device):
    """Rows whose numerics break a sorted-batch merge: exact reference
    points, ties within the slot, values below the reference minimum and
    above its maximum. Slot 0 holds one valid row and slot 1 none (S > 1);
    the other slots fill 0..B rows."""
    import numpy as np
    import torch

    from mlops_tpu_torch.data import generate_synthetic

    rng = np.random.default_rng(seed)
    columns, _ = generate_synthetic(s * b, seed=seed, drift=0.4)
    ds = prep.encode(columns)
    cat = ds.cat_ids.reshape(s, b, -1)
    num = ds.numeric.reshape(s, b, -1).astype(np.float32)
    ref = ref_sorted.cpu().numpy()
    m, r = ref.shape
    span = ref[:, -1] - ref[:, 0] + 1.0
    pick = rng.integers(0, 5, size=(s, b, m))
    at_ref = ref[np.arange(m), rng.integers(0, r, size=(s, b, m))]
    num = np.where(pick == 1, at_ref, num)
    num = np.where(pick == 2, ref[:, 0] - rng.uniform(0.1, 2.0, (s, b, m)) * span, num)
    num = np.where(pick == 3, ref[:, -1] + rng.uniform(0.1, 2.0, (s, b, m)) * span, num)
    num = np.where(pick == 4, num[:, :1, :], num).astype(np.float32)
    mask = np.zeros((s, b), bool)
    if s == 1:
        mask[0, : int(rng.integers(1, b + 1))] = True
    else:
        mask[0, int(rng.integers(0, b))] = True
        for i in range(2, s):
            mask[i, : int(rng.integers(0, b + 1))] = True
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (cat, num, mask)
    )


# K-S edge cases (S, B): every solo bucket, the 64-slot groups, and past
# 256 rows (a slot group loops over its rows).
KS_EDGE_SHAPES = [(1, 1), (1, 8), (1, 64), (1, 256), (64, 1), (64, 8), (4, 256), (3, 300)]


def _near_threshold(mon, num, mask):
    from mlops_tpu_torch.ops.outlier import mahalanobis_sq

    d2 = mahalanobis_sq(num.float(), mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    return ((d2 - thr).abs() <= FLAG_BAND * thr.abs()) & mask


def phase_parity(bundle_dir: Path) -> dict:
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
    )

    bundle = load_bundle(bundle_dir)
    dev = torch.device("cuda")
    state = (
        {k: v.to(dev) for k, v in bundle.quant_params.items()},
        bundle.monitor.to(dev),
        torch.tensor(bundle.quant_temperature, dtype=torch.float32, device=dev),
    )
    ref_sorted = state[1].num_ref_sorted
    cases = [("geometry", s, b, _inputs(bundle.preprocessor, s, b, 100 + k, dev))
             for k, (s, b) in enumerate(_geometries())]
    cases += [
        ("K-S edge", s, b, _ks_edge_inputs(bundle.preprocessor, ref_sorted, s, b, 500 + k, dev))
        for k, (s, b) in enumerate(KS_EDGE_SHAPES)
    ]
    worst = 0.0
    for what, s, b, (cat, num, mask) in cases:
        args = _core_args(state, cat, num, mask)
        got = fused_core_cuda(*args)
        again = fused_core_cuda(*args)
        torch.cuda.synchronize()
        kp, kf, kc, kk = got
        rp, rf, rc, rk = fused_core_reference(*args)
        err = (kp - rp).abs().max().item()
        worst = max(worst, err)
        near = _near_threshold(state[1], num, mask)
        flag_diff = ((kf != rf) & ~near).sum().item()
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = (
            torch.equal(kc, rc) and torch.equal(kk, rk)
            and err <= PRED_ATOL and flag_diff == 0 and repeat
        )
        log(
            f"parity {what} S={s:2d} B={b:3d}: counts/ks exact={torch.equal(kc, rc)}"
            f"/{torch.equal(kk, rk)} preds max|err|={err:.3g} "
            f"flag mismatches={flag_diff} (near threshold {int(near.sum())}) "
            f"two launches equal={repeat}"
        )
        check(ok, f"kernel disagrees with its plain version ({what}) at S={s} B={b}")
    return {"max_abs_err": worst, "shapes": len(cases)}


# ------------------------------------------------------------------ phase 5
def _cli(args: list[str], bucket: Path | None = None) -> list[str]:
    """The command of ``python -m mlops_tpu_torch <args>``; with
    ``bucket``, the same through ``gcs_main`` against that fake bucket."""
    if bucket is None:
        return [sys.executable, "-m", "mlops_tpu_torch", *args]
    return [sys.executable, "-c",
            "import sys, chip_smoke; sys.exit(chip_smoke.gcs_main(sys.argv[1], sys.argv[2:]))",
            str(bucket), *args]


def _free_port() -> int:
    """A free port below the kernel's ephemeral range. A port the kernel
    hands out (bind to 0) comes from that range, from which every outgoing
    connection also takes its local port: the bursts' clients open
    thousands, and one can take the port between this pick and the
    server's bind."""
    import random

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()  # seeded from the OS: the two sides pick apart
    for _ in range(1000):
        port = rng.randrange(max(1024, low - 12000), low)
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise SmokeFailure(f"no free port below {low}")


def _http(port: int, method: str, path: str, body: bytes | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name):
            return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"/metrics has no {name}")


def _compare_response(got: dict, want: dict, mon, prep, records, what: str,
                      quiet: bool = False):
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    p_err = float(np.abs(
        np.asarray(got["predictions"]) - np.asarray(want["predictions"])
    ).max())
    d_err = float(np.abs(
        np.asarray(list(got["feature_drift_batch"].values()))
        - np.asarray(list(want["feature_drift_batch"].values()))
    ).max())
    check(
        list(got["feature_drift_batch"]) == list(want["feature_drift_batch"]),
        f"{what}: drift keys differ",
    )
    ds = prep.encode(records_to_columns(records))
    num = torch.from_numpy(ds.numeric)
    near = _near_threshold(mon, num, torch.ones(len(records), dtype=torch.bool))
    diff = np.asarray(got["outliers"]) != np.asarray(want["outliers"])
    flag_diff = int((diff & ~near.numpy()).sum())
    if not quiet:
        log(f"{what}: preds |err|={p_err:.3g} drift |err|={d_err:.3g} "
            f"flag mismatches={flag_diff}")
    check(p_err <= PRED_ATOL and d_err <= DRIFT_ATOL and flag_diff == 0,
          f"{what}: response disagrees with the plain version on the CPU")


def phase_serve(bundle_dir: Path, device: str = "cuda") -> dict:
    """The main path. ``device="cpu"`` rehearses it without a card (the
    kernel then never launches); the smoke run itself uses the card."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
    from mlops_tpu_torch.schema.validate import records_to_columns
    from mlops_tpu_torch.serve.engine import InferenceEngine

    bundle = load_bundle(bundle_dir)
    cpu = InferenceEngine(bundle, serve_tier="quant", device="cpu")
    mon_cpu = bundle.monitor
    port = _free_port()
    server_log = WORK / "server.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    bodies = {
        "golden": json.loads((ROOT / "tests/golden/sample-request.json").read_text()),
        "5": _records(5, 11),
        "64": _records(64, 12, drift=0.5),
        "256": _records(256, 13),
    }
    with open(server_log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={bundle_dir}", f"serve.port={port}",
             "serve.host=127.0.0.1", f"serve.device={device}",
             "serve.serve_tier=quant"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 600
        while True:
            check(proc.poll() is None,
                  f"server exited early ({proc.returncode}); see {server_log}")
            try:
                status, _ = _http(port, "GET", "/healthz/ready")
                if status == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "server never became ready")
            time.sleep(0.5)
        status, _ = _http(port, "GET", "/healthz/live")
        check(status == 200, f"/healthz/live answered {status}")
        _, text = _http(port, "GET", "/metrics")
        launches_before = _metric(text.decode(), "mlops_tpu_kernel_launches_total")
        sent = 0
        for name, records in bodies.items():
            status, body = _http(port, "POST", "/predict",
                                 json.dumps(records).encode())
            check(status == 200, f"/predict {name} answered {status}: {body[:200]}")
            got = json.loads(body)
            check(len(got["predictions"]) == len(records), f"{name}: row count")
            check(all(math.isfinite(x) for x in got["predictions"]),
                  f"{name}: non-finite predictions")
            want = cpu.predict_records(records)
            _compare_response(got, want, mon_cpu, bundle.preprocessor,
                              records, f"http {name}")
            sent += len(records)
        status, _ = _http(port, "POST", "/predict",
                          json.dumps(_records(257, 14)).encode())
        check(status == 413, f"257 records answered {status}, expected 413")
        status, _ = _http(port, "POST", "/predict", b'[{"sex": 1}]')
        check(status == 422, f"malformed body answered {status}, expected 422")
        _, text = _http(port, "GET", "/metrics")
        text = text.decode()
        rows = _metric(text, "mlops_tpu_rows_scored_total")
        http_launches = int(
            _metric(text, "mlops_tpu_kernel_launches_total") - launches_before
        )
        log(f"http: rows={rows} sent={sent} kernel launches={http_launches}")
        check(rows == sent, f"/metrics rows {rows} != records sent {sent}")
        expected = len(bodies) if device == "cuda" else 0
        check(http_launches == expected,
              f"{http_launches} kernel launches for {len(bodies)} requests")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        check(code == 0, f"server exit code {code} after SIGTERM")
        check("drained; exiting" in server_log.read_text(),
              "server did not log a clean drain")
        log("http: SIGTERM drained cleanly")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    engine = InferenceEngine(bundle, serve_tier="quant", device=device)
    engine.warmup()
    quant_kernel_launches.reset()
    for rows in (1, 8):
        records = _records(64 * rows, 20 + rows, drift=0.3)
        rng = np.random.default_rng(rows)
        sizes = [1] * 64 if rows == 1 else list(rng.integers(1, 9, size=64))
        sizes[0] = rows
        parts, groups, offset = [], [], 0
        ds = bundle.preprocessor.encode(records_to_columns(records))
        for n in sizes:
            parts.append((ds.cat_ids[offset: offset + n],
                          ds.numeric[offset: offset + n]))
            groups.append(records[offset: offset + n])
            offset += n
        got = engine.fetch_group(engine.dispatch_group_arrays(parts))
        want = cpu.fetch_group(cpu.dispatch_group_arrays(parts))
        check(len(got) == len(parts), f"group 64x{rows}: response count")
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_response(g, w, mon_cpu, bundle.preprocessor, groups[i],
                              f"group 64x{rows} slot {i}", quiet=True)
        log(f"group 64x{rows}: {len(got)} responses agree with the CPU")
    group_launches = quant_kernel_launches.value
    snap = engine.monitor_snapshot()
    check(snap["batches"] == 128, f"grouped batches {snap['batches']} != 128")
    return {"launches": http_launches + group_launches, "engine": engine}


# ------------------------------------------------------------------ phase 6
def _event_ms(fn, iters: int) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(launch, n: int = 100, replays: int = 5) -> float:
    """Device time per launch of a short kernel: ``n`` launches
    (``launch(stream)``) captured in one CUDA graph and replayed between
    two events, so the host submits one graph and not n calls. Events
    around back-to-back calls time the host's submission instead once a
    kernel is shorter than it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            launch(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def _profiler_ms(launch, kernel: str, n: int = 100) -> float | None:
    """The mean device time of the kernels whose name holds ``kernel``
    over ``n`` launches under ``torch.profiler`` (CUPTI's start-to-end
    times), or None if the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(5):
        launch(stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch(stream)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA and kernel in event.key:
            us = getattr(event, "self_device_time_total", None)
            total += float(us if us is not None else event.self_cuda_time_total)
            count += event.count
    return total / count / 1e3 if count else None


def _raw_launcher(args, outs, s: int, b: int, r: int, work=None):
    """The kernel's C entry point called directly on preallocated outputs
    (and, past 256 rows, the sort's workspace) as ``launch(stream)``,
    without the wrapper's checks; and the library's empty launch of the
    same grid, made the same way."""
    from mlops_tpu_torch.ops.quant_kernel import load_library

    lib = load_library()
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    ptrs.append(work.data_ptr() if work is not None else None)
    words = work.shape[-1] if work is not None else 0

    def launch(stream):
        err = lib.quant_fused_launch(*ptrs, s, b, r, words, 0, stream)
        if err != 0:
            raise SmokeFailure(f"raw launch failed: cudaError {err}")

    def empty(stream):
        err = lib.quant_fused_empty_launch(s, b, r, 0, stream)
        if err != 0:
            raise SmokeFailure(f"empty launch failed: cudaError {err}")

    return launch, empty


def _bound(args, outs, s: int, b: int, n_valid: list[int], r: int):
    """Least time for one launch: every input read once and every output
    written once at the HBM rate, against the operations the function
    needs on these inputs at the f32 peak. Operations: the MLP and
    Mahalanobis FMAs (2 ops each) for every row, one category-count
    increment per valid row and categorical, and per slot and numeric
    feature the comparisons of a sort-and-merge ECDF over the slot's n
    valid rows (n log2 n to sort the batch column, R + n to merge it with
    the sorted reference). This is the function's work, not the current
    kernel's dense R x B and B x B comparison planes."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if isinstance(t, torch.Tensor))
    c, e, m, h = 9, 4, 14, 32
    din = c * e + m
    per_row = 2 * din * h + 2 * h + 2 * m * m + 2 * m
    ops = s * b * per_row
    for n in n_valid:
        if n:
            ops += c * n + m * (n * math.ceil(math.log2(max(n, 2))) + r + n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(bundle_dir: Path, engine) -> list[dict]:
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
    )

    bundle = load_bundle(bundle_dir)
    dev = torch.device("cuda")
    state = (
        {k: v.to(dev) for k, v in bundle.quant_params.items()},
        bundle.monitor.to(dev),
        torch.tensor(bundle.quant_temperature, dtype=torch.float32, device=dev),
    )
    r = bundle.monitor.num_ref_sorted.shape[1]
    rows = []
    for s, b in ((1, 1), (1, 256), (64, 1), (64, 8)):
        cat, num, mask = _inputs(bundle.preprocessor, s, b, 300 + s + b, dev)
        args = _core_args(state, cat, num, mask)
        outs = fused_core_cuda(*args)
        launch, empty = _raw_launcher(args, outs, s, b, r)
        stream = torch.cuda.current_stream().cuda_stream
        kernel_ms = _graph_ms(launch)
        profiler_ms = _profiler_ms(launch, "quant_fused_kernel")
        host_paced_ms = _event_ms(lambda: launch(stream), 200)
        empty_ms = _graph_ms(empty)
        empty_profiler_ms = _profiler_ms(empty, "quant_empty_kernel")
        empty_host_paced_ms = _event_ms(lambda: empty(stream), 200)
        wrapper_ms = _event_ms(lambda: fused_core_cuda(*args), 200)
        plain_ms = _event_ms(lambda: fused_core_reference(*args), 20)
        bound_ms, bound_by = _bound(
            args, outs, s, b, mask.sum(dim=1).tolist(), r
        )
        row = {
            "shape": f"{s}x{b}",
            "ms": kernel_ms,
            "profiler_ms": profiler_ms,
            "host_paced_ms": host_paced_ms,
            "empty_launch_ms": empty_ms,
            "empty_launch_profiler_ms": empty_profiler_ms,
            "empty_launch_host_paced_ms": empty_host_paced_ms,
            "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "dispatch_fetch_ms_p50": _dispatch_fetch_p50(
                engine, bundle.preprocessor, s, b, 300 + s + b),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        log_timing("timing", row)
        rows.append(row)
    return rows


# ------------------------------------------------------------------ phase 7
def _tile_edge_cases():
    """bf16 shapes at the kernels' tile edges (128-row forward blocks over
    128-key tiles, 128-key dk/dv blocks over 64-query tiles), cross
    lengths both ways, every head_dim: (what, (B, S_q, S_kv, H, D), dtype)."""
    import torch

    from mlops_tpu_torch.ops.attention import KERNEL_HEAD_DIMS

    lengths = [(s, s) for s in (127, 128, 129, 255, 256, 257, 508)]
    lengths += [(45, 70), (70, 45)]
    return [
        ("tile edge", (2, s_q, s_kv, 2, d), torch.bfloat16)
        for d in KERNEL_HEAD_DIMS for s_q, s_kv in lengths
    ]


# f32 cases at the head dims ROADMAP C1 added (the bf16 ones are tile edges).
C1_F32_CASES = [
    ("head_dim 8", (2, 200, 200, 4, 8)),
    ("head_dim 128", (1, 140, 140, 2, 128)),
    ("head_dim 128 cross-length", (2, 70, 45, 2, 128)),
]


def _qkv_views(b: int, s_q: int, s_kv: int, h: int, d: int, dtype, seed: int):
    """q, k and v as the doc model hands them to the kernel: strided views
    of one [B, S, 3, H, D] projection (separate tensors when q and kv
    differ in length)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            "cuda", dtype
        )

    if s_q == s_kv:
        qkv = normal(b, s_q, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return normal(b, s_q, h, d), normal(b, s_kv, h, d), normal(b, s_kv, h, d)


def phase_flash_parity() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    cases = [
        ("full width", (256, 508, 508, 8, 32), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.bfloat16),
        ("cross-length", (2, 45, 70, 2, 32), torch.float32),
    ] + [(what, shape, torch.float32) for what, shape in C1_F32_CASES]
    cases += _tile_edge_cases()
    rows = []
    for k, (what, shape, dtype) in enumerate(cases):
        q, k_, v = _qkv_views(*shape, dtype, seed=40 + k)
        before = attention.flash_kernel_launches.value
        out, lse = attention.flash_forward_cuda(q, k_, v)
        torch.cuda.synchronize()
        launched = attention.flash_kernel_launches.value - before
        ref_out, ref_lse = attention.flash_forward_reference(q, k_, v)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        name = str(dtype).split(".")[-1]
        out_tol, lse_tol = FLASH_TOL[name]
        row = {
            "case": what, "shape": list(shape), "dtype": name,
            "out_err": out_err, "lse_err": lse_err,
        }
        log(f"flash parity {json.dumps(row)}")
        check(launched == 1, f"flash {what}: launch counter rose by {launched}")
        check(
            math.isfinite(out_err) and out_err <= out_tol and lse_err <= lse_tol,
            f"flash kernel disagrees with its plain version: {row}",
        )
        rows.append(row)
        del q, k_, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return {"max_abs_err": rows[0]["out_err"], "cases": rows}


# ------------------------------------------------------------------ phase 8
def _doc_config():
    from mlops_tpu_torch.config import ModelConfig

    # configs/long_context_job.toml's model, on one card (dense attention).
    return ModelConfig(
        family="bert", doc_records=11, token_dim=256, depth=DOC_DEPTH,
        heads=8, precision="bf16", dropout=0.0,
    )


def phase_doc_bundle(seed: int = 0) -> tuple[Path, Path]:
    from mlops_tpu_torch.bundle import save_doc_bundle
    from mlops_tpu_torch.data import (
        Preprocessor,
        generate_synthetic,
        write_csv_columns,
    )
    from mlops_tpu_torch.models import init_params
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.train.long_context import build_doc_model

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    config = _doc_config()
    model = init_params(build_doc_model(config), seed)
    directory = WORK / "doc_bundle"
    shutil.rmtree(directory, ignore_errors=True)
    save_doc_bundle(
        directory, config, model, prep, fit_monitor(prep.encode(columns)),
        tags={"source": "chip_smoke.py", "note": "seeded weights, not trained"},
    )
    history = WORK / "history.csv"
    rows, _ = generate_synthetic(300 * 11 + 7, seed=seed + 1)
    write_csv_columns(history, rows)
    log(f"doc bundle: {directory}; history: {history} ({300 * 11 + 7} rows)")
    return directory, history


def phase_doc_path(bundle_dir: Path, history: Path, device: str = "cuda") -> dict:
    """The doc path's main run: predict-file in a subprocess and the same
    function here, then the checks against dense attention and the CPU.
    ``device="cpu"`` rehearses it without a card (the kernel then never
    launches); the smoke run itself uses the card."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.commands import predict_documents, predict_file
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.data import load_csv_columns
    from mlops_tpu_torch.models.layers import MultiHeadSelfAttention
    from mlops_tpu_torch.ops.attention import flash_kernel_launches

    overrides = [
        f"data.train_path={history}", f"serve.model_directory={bundle_dir}",
        "serve.max_batch=128", f"serve.device={device}",
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "predict-file", *overrides],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0,
          f"predict-file exited {proc.returncode}: {proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    preds = np.asarray(sub["predictions"])
    log(
        f"predict-file subprocess: {time.perf_counter() - t0:.1f} s, "
        f"documents={sub['documents']} records_per_document="
        f"{sub['records_per_document']} rows_dropped={sub['rows_dropped']}"
    )
    check(
        (sub["documents"], sub["records_per_document"], sub["rows_dropped"])
        == (300, 11, 7),
        f"predict-file counts {sub['documents']}/{sub['records_per_document']}"
        f"/{sub['rows_dropped']}, expected 300/11/7",
    )
    check(
        preds.shape == (300,) and np.isfinite(preds).all()
        and (preds >= 0).all() and (preds <= 1).all(),
        "predict-file predictions are not 300 finite probabilities",
    )

    flash_kernel_launches.reset()
    here = predict_file(load_config(overrides))
    launches = flash_kernel_launches.value
    gap = float(np.abs(np.asarray(here["predictions"]) - preds).max())
    log(f"predict-file in process: flash launches={launches}, "
        f"max |gap| to the subprocess={gap:.3g}")
    check(here == sub, "in-process predict-file differs from the subprocess's")
    expected = DOC_DEPTH * math.ceil(300 / 128) if device == "cuda" else 0
    check(launches == expected,
          f"flash launched {launches} times, expected {expected}")

    dense = load_bundle(bundle_dir)
    for mod in dense.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            mod.use_flash = False  # the dense reference at S = 508
    ds = dense.preprocessor.encode(load_csv_columns(history)[0])
    flash_kernel_launches.reset()
    plain = predict_documents(dense, ds, 128, device)
    check(flash_kernel_launches.value == 0, "dense run launched the kernel")
    dense_gap = float(np.abs(np.asarray(plain["predictions"]) - preds).max())

    cpu = load_bundle(bundle_dir)
    n = 16 * 11
    head = type(ds)(cat_ids=ds.cat_ids[:n], numeric=ds.numeric[:n])
    on_cpu = predict_documents(cpu, head, 128, "cpu")
    cpu_gap = float(np.abs(np.asarray(on_cpu["predictions"]) - preds[:16]).max())
    log(f"doc predictions vs dense attention on the card: max |gap| "
        f"{dense_gap:.3g}; vs the port on the CPU (16 documents): {cpu_gap:.3g}")
    check(dense_gap <= DOC_PRED_ATOL and cpu_gap <= DOC_PRED_ATOL,
          f"doc predictions disagree: dense {dense_gap}, cpu {cpu_gap}")
    return {"launches": launches, "dense_gap": dense_gap, "cpu_gap": cpu_gap}


# ------------------------------------------------------------------ phase 9
def _flash_bound(q, out, lse, s_kv: int):
    """Least time for one forward: q, k, v read once and out, lse written
    once at the HBM rate; 4*B*H*Sq*Skv*D FLOPs of products at the bf16
    tensor-core peak; B*H*Sq*Skv exponentials at the special-function
    rate. The largest decides (bytes, or operations)."""
    b, s_q, h, d = q.shape
    nbytes = (b * s_q * h * d + 2 * b * s_kv * h * d) * q.element_size()
    nbytes += out.numel() * out.element_size() + lse.numel() * lse.element_size()
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "tensor_flops": 4 * b * h * s_q * s_kv * d / BF16_TC_FLOPS * 1e3,
        "exponentials": b * h * s_q * s_kv / EXP_OPS_PER_S * 1e3,
    }
    bound = max(terms.values())
    return bound, ("bytes" if terms["bytes"] == bound else "operations"), terms


def phase_flash_timing(bundle_dir: Path) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.commands import predict_documents
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.ops import attention

    q, k, v = _qkv_views(256, 508, 508, 8, 32, torch.bfloat16, seed=90)
    out, lse = attention.flash_forward_cuda(q, k, v)
    # The kernel alone: the wrapper's own launch on preallocated outputs.
    kernel_ms = _event_ms(lambda: attention.launch(q, k, v, out, lse), 50)
    wrapper_ms = _event_ms(lambda: attention.flash_forward_cuda(q, k, v), 50)
    plain_ms = _event_ms(lambda: attention.flash_forward_reference(q, k, v), 5)
    # SDPA's layout, [B,H,S,D], copied outside the timed calls.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = _event_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt), 50
    )
    bound_ms, bound_by, terms = _flash_bound(q, out, lse, k.shape[1])
    del q, k, v, out, lse, qt, kt, vt
    torch.cuda.empty_cache()

    bundle = load_bundle(bundle_dir)
    columns, _ = generate_synthetic(1024 * 11, seed=7)
    ds = bundle.preprocessor.encode(columns)
    predict_documents(bundle, ds, 256, "cuda")  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict_documents(bundle, ds, 256, "cuda")
        walls.append(time.perf_counter() - t0)
    docs_per_s = 1024 / float(np.median(walls))
    cat = torch.from_numpy(ds.cat_ids[: 256 * 11].reshape(256, 11, -1)).cuda()
    num = torch.from_numpy(ds.numeric[: 256 * 11].reshape(256, 11, -1)).cuda()
    with torch.inference_mode():
        chunk_ms = _event_ms(lambda: bundle.model(cat, num), 10)
    row = {
        "shape": "256x508x8x32 bf16",
        "ms": kernel_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_terms_ms": terms,
        "docs_per_s": docs_per_s,
        "chunk_forward_ms": chunk_ms,
        "kernel_share_of_chunk": DOC_DEPTH * kernel_ms / chunk_ms,
    }
    log_timing("flash timing", row)
    return row

# ----------------------------------------------------------------- phase 10
def _grad_tol(want) -> float:
    """f32: 5e-5 + 1e-4 x the largest magnitude (the JAX package's ragged
    flash-gradient tolerance); bf16: two bf16 ulps at it."""
    import torch

    big = want.float().abs().max().item()
    if want.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.floor(math.log2(max(big, 1e-30))) - 7)
    return 5e-5 + 1e-4 * big


def _normal_like(x, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(
        x.device, x.dtype
    )


def phase_bwd_parity() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    cases = [
        ("training shape", (64, 508, 508, 8, 32), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.bfloat16),
        ("doc_records 3", (4, 140, 140, 2, 16), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.float32),
        ("ragged", (2, 200, 200, 4, 64), torch.bfloat16),
        ("cross-length", (2, 45, 70, 2, 32), torch.float32),
    ] + [(what, shape, torch.float32) for what, shape in C1_F32_CASES]
    cases += _tile_edge_cases()
    rows = []
    for n, (what, shape, dtype) in enumerate(cases):
        q, k, v = _qkv_views(*shape, dtype, seed=60 + n)
        do = _normal_like(q, seed=80 + n)
        out, lse = attention.flash_forward_cuda(q, k, v)
        before = (attention.flash_bwd_dq_launches.value,
                  attention.flash_bwd_dkv_launches.value)
        got = attention.flash_backward_cuda(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        launched = (attention.flash_bwd_dq_launches.value - before[0],
                    attention.flash_bwd_dkv_launches.value - before[1])
        if n == 0:  # each dq block owns its rows: a second launch, the same bits
            again = attention.flash_bwd_dq_cuda(
                q, k, v, do, lse, attention.flash_delta(out, do)
            )
            check(torch.equal(again, got[0]), "two dq launches differ")
            log("flash backward: two dq launches at the training shape are bitwise equal")
        want = attention.flash_backward_reference(q, k, v, out, lse, do)
        errs = {
            name: (g.float() - w.float()).abs().max().item()
            for name, g, w in zip(("dq", "dk", "dv"), got, want)
        }
        tols = {name: _grad_tol(w) for name, w in zip(("dq", "dk", "dv"), want)}
        row = {"case": what, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "err": errs, "tol": tols}
        log(f"flash backward parity {json.dumps(row)}")
        check(launched == (1, 1), f"backward {what}: launch counters rose by {launched}")
        check(
            all(math.isfinite(e) and e <= tols[name] for name, e in errs.items()),
            f"flash backward kernels disagree with their plain version: {row}",
        )
        rows.append(row)
        del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return {"dq_err": rows[0]["err"]["dq"],
            "dkv_err": max(rows[0]["err"]["dk"], rows[0]["err"]["dv"]),
            "cases": rows}


# ----------------------------------------------------------------- phase 11
def _launch_counts() -> tuple[int, int, int]:
    from mlops_tpu_torch.ops import attention

    return (attention.flash_kernel_launches.value,
            attention.flash_bwd_dq_launches.value,
            attention.flash_bwd_dkv_launches.value)


def _reset_launch_counts() -> None:
    from mlops_tpu_torch.ops import attention

    for counter in (attention.flash_kernel_launches, attention.flash_bwd_dq_launches,
                    attention.flash_bwd_dkv_launches):
        counter.reset()


def _train_documents(config, rows: int, seed: int, device):
    """Documents of ``rows`` synthetic rows as (cat, num, label) tensors on
    ``device``."""
    import torch

    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.train.long_context import make_documents

    columns, labels = generate_synthetic(rows, seed=seed)
    ds = Preprocessor.fit(columns).encode(columns, labels)
    return tuple(
        torch.from_numpy(a).to(device) for a in make_documents(ds, config.doc_records)
    )


def _doc_trainer(config, device, flash: bool):
    """The job's trainer (learning rate 1e-3, seeded init 0); ``flash``
    False puts every attention module on the dense reference."""
    from mlops_tpu_torch.config import TrainConfig
    from mlops_tpu_torch.models.layers import MultiHeadSelfAttention
    from mlops_tpu_torch.train.long_context import make_doc_train_step

    trainer = make_doc_train_step(
        config, TrainConfig(learning_rate=1e-3, device=str(device)), seed=0
    )
    for mod in trainer.model.modules():
        if isinstance(mod, MultiHeadSelfAttention):
            mod.use_flash = None if flash else False
    return trainer


def phase_train_parity(config=None, batch: int = 64, steps: int = 30,
                       device: str = "cuda") -> dict:
    """Flash against dense attention in training at the job's width.
    ``device="cpu"`` (with a small ``config``) rehearses it without a
    card: both routes are then dense and nothing launches."""
    import torch

    from mlops_tpu_torch.train.loop import sigmoid_bce
    from mlops_tpu_torch.train.loop import batch_indices

    config = config or _doc_config()
    cat, num, lab = _train_documents(config, 20000, seed=3, device=device)
    n_docs = cat.shape[0]
    on_card = device == "cuda"
    per_step = (config.depth,) * 3 if on_card else (0, 0, 0)

    def batch_of(step):
        idx = torch.from_numpy(batch_indices(n_docs, batch, 0, step)).to(device)
        return cat[idx], num[idx], lab[idx]

    grads = {}
    for route in ("flash", "dense"):
        trainer = _doc_trainer(config, device, route == "flash")
        _reset_launch_counts()
        c, x, y = batch_of(1)
        sigmoid_bce(trainer.model(c, x), y).backward()
        counts = _launch_counts()
        want = per_step if route == "flash" else (0, 0, 0)
        check(counts == want, f"{route} gradient step launched {counts}, expected {want}")
        grads[route] = {k: p.grad.float().flatten() for k, p in trainer.model.named_parameters()}
        del trainer
    stats = []
    for name, g in grads["flash"].items():
        d = grads["dense"][name]
        cos = torch.nn.functional.cosine_similarity(g, d, dim=0).item()
        ratio = (g.norm() / d.norm().clamp_min(1e-30)).item()
        stats.append((name, cos, ratio))
        check(cos >= GRAD_COSINE_MIN and abs(ratio - 1) <= GRAD_NORM_RTOL,
              f"{name}: flash vs dense gradient cosine {cos:.5f}, norm ratio {ratio:.5f}")
    cos_name, worst_cos, _ = min(stats, key=lambda t: t[1])
    ratio_name, _, worst_ratio = max(stats, key=lambda t: abs(t[2] - 1))
    log(f"train gradients flash vs dense ({len(stats)} parameters): worst "
        f"cosine {worst_cos:.6f} ({cos_name}), worst norm ratio "
        f"{worst_ratio:.6f} ({ratio_name})")
    del grads

    curves = {}
    for route in ("flash", "dense"):
        trainer = _doc_trainer(config, device, route == "flash")
        losses = []
        for step in range(1, steps + 1):
            _reset_launch_counts()
            losses.append(float(trainer.step(*batch_of(step))))
            counts = _launch_counts()
            want = per_step if route == "flash" else (0, 0, 0)
            check(counts == want, f"{route} step {step} launched {counts}, expected {want}")
        curves[route] = losses
        del trainer
    gaps = [abs(a - b) for a, b in zip(curves["flash"], curves["dense"])]
    first, last = sum(curves["flash"][:10]) / 10, sum(curves["flash"][-10:]) / 10
    row = {
        "steps": steps, "batch": batch, "max_gap": max(gaps),
        "mean_gap": sum(gaps) / len(gaps), "first10_mean": first, "last10_mean": last,
        "flash": [round(v, 5) for v in curves["flash"]],
        "dense": [round(v, 5) for v in curves["dense"]],
    }
    log(f"train loss curves {json.dumps(row)}")
    check(all(math.isfinite(v) for v in curves["flash"] + curves["dense"]),
          "non-finite training loss")
    check(max(gaps) <= CURVE_MAX_GAP and row["mean_gap"] <= CURVE_MEAN_GAP,
          f"flash and dense loss curves part: max {max(gaps)}, mean {row['mean_gap']}")
    check(last < first, f"the flash run's loss does not fall: {first} -> {last}")
    if on_card:
        torch.cuda.empty_cache()
    return {"worst_cosine": worst_cos, "worst_norm_ratio": worst_ratio, **row}


# ----------------------------------------------------------------- phase 12
def phase_train_path(history: Path, extra: tuple[str, ...] = (),
                     device: str = "cuda") -> dict:
    """The training main path: the CLI in a subprocess, predict-file on
    its bundle, then the same function here with the launch counts read.
    ``extra`` overrides and ``device="cpu"`` rehearse it small on the CPU
    (nothing launches there)."""
    import numpy as np

    from mlops_tpu_torch.commands import predict_file, train
    from mlops_tpu_torch.config import load_config

    root = WORK / "train"
    shutil.rmtree(root, ignore_errors=True)
    cuts = [f"train.steps={TRAIN_STEPS_CUT}", f"train.eval_every={TRAIN_EVAL_EVERY_CUT}"]
    overrides = [
        "model.seq_parallel=false", *cuts, f"registry.root={root / 'registry'}",
        f"registry.run_root={root / 'runs'}", f"train.device={device}", *extra,
    ]
    config = load_config(overrides, ROOT / JOB_TOML)
    log(f"train: {JOB_TOML} with model.seq_parallel=false (one card: the dense "
        f"path); cut: {' '.join(cuts)} (the job: train.steps=2000 "
        f"train.eval_every=200); rows {config.data.rows}, batch "
        f"{config.train.batch_size}, {config.model.token_dim}/{config.model.depth}/"
        f"{config.model.heads}, {config.model.precision}: the job's")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "train", "--config", JOB_TOML,
         *overrides, "registry.run_name=cli"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=900,
    )
    check(proc.returncode == 0, f"train exited {proc.returncode}: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"train subprocess: {time.perf_counter() - t0:.1f} s: {json.dumps(out)}")
    check(set(out) == {"bundle", "model_uri", "run_dir", "steps", "packaged_step", "metrics"},
          f"train printed keys {sorted(out)}")
    check(out["steps"] == TRAIN_STEPS_CUT and out["packaged_step"] == TRAIN_STEPS_CUT,
          f"train steps {out['steps']}/{out['packaged_step']}")
    check(len(out["metrics"]) == 5 and all(math.isfinite(v) for v in out["metrics"].values()),
          f"train metrics {out['metrics']}")
    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    check([r["step"] for r in rows] == list(
        range(TRAIN_EVAL_EVERY_CUT, TRAIN_STEPS_CUT + 1, TRAIN_EVAL_EVERY_CUT)),
        f"metrics.jsonl steps {[r['step'] for r in rows]}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    check(manifest["flavor"] == "doc" and manifest["tags"]["trained_with"]
          == "long_context dense", "the bundle is not a dense-trained doc bundle")

    scored = predict_file(load_config([
        f"data.train_path={history}", f"serve.model_directory={out['bundle']}",
        "serve.max_batch=128", f"serve.device={device}",
    ]))
    preds = np.asarray(scored["predictions"])
    log(f"predict-file on the trained bundle: {scored['documents']} documents, "
        f"mean probability {preds.mean():.4f}")
    check(scored["documents"] == 300 and np.isfinite(preds).all()
          and ((preds >= 0) & (preds <= 1)).all(),
          "predict-file on the trained bundle: not 300 finite probabilities")

    config.registry.run_name = "in_process"
    _reset_launch_counts()
    here = train(config)
    counts = _launch_counts()
    valid_docs = int(config.data.rows * config.data.valid_fraction) // config.model.doc_records
    chunks = math.ceil(valid_docs / 256)
    evals = TRAIN_STEPS_CUT // TRAIN_EVAL_EVERY_CUT + 1  # and the calibration's
    depth = config.model.depth
    want = (
        (depth * (TRAIN_STEPS_CUT + evals * chunks), depth * TRAIN_STEPS_CUT,
         depth * TRAIN_STEPS_CUT) if device == "cuda" else (0, 0, 0)
    )
    log(f"train in process: launches forward/dq/dkv {counts} (expected {want}); "
        f"metrics {json.dumps(here['metrics'])}")
    check(counts == want, f"training launched {counts}, expected {want}")
    return {"launches": counts, "cli": out, "in_process": here}


# ----------------------------------------------------------------- phase 13
def _bwd_bound(q, k, outputs: int):
    """Least time for one backward kernel: q, k, v, do read once, lse and
    delta once, ``outputs`` gradient tensors written once, at the HBM
    rate; its products (3 for dq, 4 for dk/dv, each 2*B*H*Sq*Skv*D FLOPs)
    at the bf16 tensor-core peak; B*H*Sq*Skv exponentials at the
    special-function rate. The largest decides."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    el = q.element_size()
    nbytes = (2 * b * s_q * h * d + 2 * b * s_kv * h * d) * el + 2 * b * h * s_q * 4
    nbytes += outputs * (b * (s_q if outputs == 1 else s_kv) * h * d) * el
    products = 3 if outputs == 1 else 4
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "tensor_flops": products * 2 * b * h * s_q * s_kv * d / BF16_TC_FLOPS * 1e3,
        "exponentials": b * h * s_q * s_kv / EXP_OPS_PER_S * 1e3,
    }
    bound = max(terms.values())
    return bound, ("bytes" if terms["bytes"] == bound else "operations"), terms


def phase_train_timing() -> dict:
    import torch

    from mlops_tpu_torch.ops import attention

    config = _doc_config()
    cat, num, lab = _train_documents(config, 64 * 11, seed=5, device="cuda")
    trainer = _doc_trainer(config, "cuda", flash=True)
    step_ms = _event_ms(lambda: trainer.step(cat, num, lab), 20)
    del trainer
    torch.cuda.empty_cache()

    q, k, v = _qkv_views(64, 508, 508, 8, 32, torch.bfloat16, seed=92)
    do = _normal_like(q, seed=93)
    out, lse = attention.flash_forward_cuda(q, k, v)
    delta = attention.flash_delta(out, do)
    dq = torch.empty_like(out)
    dk, dv = torch.empty_like(out), torch.empty_like(out)
    dq_ms = _event_ms(lambda: attention.launch_dq(q, k, v, do, lse, delta, dq), 50)
    dkv_ms = _event_ms(lambda: attention.launch_dkv(q, k, v, do, lse, delta, dk, dv), 50)
    plain_ms = _event_ms(
        lambda: attention.flash_backward_reference(q, k, v, out, lse, do), 5
    )
    # SDPA's backward (its flash backend) as one call of the aten op, in
    # its layout [B,H,S,D] copied outside the timed calls, as the kernels
    # are timed through their launch helpers: no autograd on the host,
    # whose speed would otherwise decide the time.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    fo = sdpa_fwd(qt, kt, vt, 0.0, False, False)
    bwd_args = (dot, qt, kt, vt, *fo[:6], 0.0, False, fo[6], fo[7])
    library_ms = _event_ms(lambda: sdpa_bwd(*bwd_args), 50)
    sdpa_fwd_ms = _event_ms(lambda: sdpa_fwd(qt, kt, vt, 0.0, False, False), 50)
    sdpa_dq = sdpa_bwd(*bwd_args)[0].transpose(1, 2)
    ours_dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    sdpa_gap = (sdpa_dq.float() - ours_dq.float()).abs().max().item()
    dq_bound, dq_by, dq_terms = _bwd_bound(q, k, 1)
    dkv_bound, dkv_by, dkv_terms = _bwd_bound(q, k, 2)
    depth = config.depth
    row = {
        "shape": "64x508x8x32 bf16",
        "step_ms": step_ms,
        "docs_per_s": 64 / step_ms * 1e3,
        "dq_ms": dq_ms, "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
        "dq_bound_terms_ms": dq_terms,
        "dkv_ms": dkv_ms, "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
        "dkv_bound_terms_ms": dkv_terms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "sdpa_fwd_ms": sdpa_fwd_ms,
        "dq_max_gap_to_sdpa": sdpa_gap,
        "fwd_ms_at_batch_64": _event_ms(lambda: attention.launch(q, k, v, out, lse), 50),
    }
    row["attention_share_of_step"] = (
        depth * (row["fwd_ms_at_batch_64"] + dq_ms + dkv_ms) / step_ms
    )
    log_timing("train timing", row)
    del q, k, v, do, out, lse, delta, dq, dk, dv, qt, kt, vt, dot, fo, sdpa_dq, ours_dq
    torch.cuda.empty_cache()
    return row


# ----------------------------------------------------------------- phase 14
# The doc model at the head dims ROADMAP C1 added: the config's default
# width (token_dim 64 over 8 heads: head_dim 8) and head_dim 128.
C1_CONFIGS = {
    8: dict(token_dim=64, heads=8, depth=3),
    128: dict(token_dim=256, heads=2, depth=2),
}
C1_STEPS = 5


def _c1_config(d: int):
    from mlops_tpu_torch.config import ModelConfig

    return ModelConfig(family="bert", doc_records=11, precision="bf16",
                       dropout=0.0, **C1_CONFIGS[d])


def phase_c1_train(device: str = "cuda") -> dict:
    """A few training steps of the doc model at head_dim 8 and 128 through
    the flash kernels, against the same steps through dense attention.
    ``device="cpu"`` rehearses it (nothing launches there)."""
    from mlops_tpu_torch.train.loop import batch_indices

    out = {}
    for d in C1_CONFIGS:
        config = _c1_config(d)
        cat, num, lab = _train_documents(config, 64 * 11 * 4, seed=8, device=device)
        per_step = (config.depth,) * 3 if device == "cuda" else (0, 0, 0)
        curves, launches = {}, None
        for route in ("flash", "dense"):
            trainer = _doc_trainer(config, device, route == "flash")
            losses = []
            _reset_launch_counts()
            for step in range(1, C1_STEPS + 1):
                idx = batch_indices(cat.shape[0], 64, 0, step)
                losses.append(float(trainer.step(cat[idx], num[idx], lab[idx])))
            counts = _launch_counts()
            want = tuple(C1_STEPS * n for n in per_step) if route == "flash" else (0, 0, 0)
            check(counts == want, f"head_dim {d} {route}: launched {counts}, expected {want}")
            if route == "flash":
                launches = counts
            curves[route] = losses
            del trainer
        gap = max(abs(a - b) for a, b in zip(curves["flash"], curves["dense"]))
        row = {"head_dim": d, "config": C1_CONFIGS[d], "launches_fwd_dq_dkv": launches,
               "max_loss_gap": gap, "flash": curves["flash"], "dense": curves["dense"]}
        log(f"C1 train {json.dumps(row)}")
        check(all(math.isfinite(v) for v in curves["flash"] + curves["dense"]),
              f"head_dim {d}: non-finite loss")
        check(gap <= C1_CURVE_MAX_GAP,
              f"head_dim {d}: flash and dense losses part by {gap}")
        out[d] = row
    return out


def phase_c1_timing() -> dict:
    """Each attention kernel at head_dim 8 and 128 at the doc model's
    shapes (a 256-document scoring chunk for the forward, a batch of 64
    for the backward), held against its plain version there (phase 7's
    and phase 10's tolerances) and timed beside its bound, its plain
    version and SDPA's forward / backward op."""
    import torch
    import torch.nn.functional as F

    from mlops_tpu_torch.ops import attention

    rows = {}
    for d, cfg in C1_CONFIGS.items():
        h = cfg["heads"]
        q, k, v = _qkv_views(256, 508, 508, h, d, torch.bfloat16, seed=94 + d)
        out, lse = attention.flash_forward_cuda(q, k, v)
        fwd_ms = _event_ms(lambda: attention.launch(q, k, v, out, lse), 50)
        fwd_plain_ms = _event_ms(lambda: attention.flash_forward_reference(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fwd_library_ms = _event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
        fwd_bound, fwd_by, _ = _flash_bound(q, out, lse, 508)
        ref_out, ref_lse = attention.flash_forward_reference(q, k, v)
        out_tol, lse_tol = FLASH_TOL["bfloat16"]
        fwd_err = {"out": (out.float() - ref_out.float()).abs().max().item(),
                   "lse": (lse - ref_lse).abs().max().item()}
        check(
            math.isfinite(fwd_err["out"]) and fwd_err["out"] <= out_tol
            and fwd_err["lse"] <= lse_tol,
            f"flash forward at head_dim {d}, 256x508x{h}: {fwd_err} "
            f"past ({out_tol}, {lse_tol})",
        )
        del q, k, v, out, lse, qt, kt, vt, ref_out, ref_lse
        torch.cuda.empty_cache()

        q, k, v = _qkv_views(64, 508, 508, h, d, torch.bfloat16, seed=96 + d)
        do = _normal_like(q, seed=97 + d)
        out, lse = attention.flash_forward_cuda(q, k, v)
        delta = attention.flash_delta(out, do)
        dq, dk, dv = (torch.empty_like(out) for _ in range(3))
        dq_ms = _event_ms(lambda: attention.launch_dq(q, k, v, do, lse, delta, dq), 50)
        dkv_ms = _event_ms(lambda: attention.launch_dkv(q, k, v, do, lse, delta, dk, dv), 50)
        bwd_plain_ms = _event_ms(
            lambda: attention.flash_backward_reference(q, k, v, out, lse, do), 3
        )
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        sdpa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
        sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        fo = sdpa_fwd(qt, kt, vt, 0.0, False, False)
        bwd_args = (dot, qt, kt, vt, *fo[:6], 0.0, False, fo[6], fo[7])
        bwd_library_ms = _event_ms(lambda: sdpa_bwd(*bwd_args), 50)
        dq_bound, dq_by, _ = _bwd_bound(q, k, 1)
        dkv_bound, dkv_by, _ = _bwd_bound(q, k, 2)
        want = attention.flash_backward_reference(q, k, v, out, lse, do)
        bwd_err = {
            name: (g.float() - w.float()).abs().max().item()
            for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)
        }
        bwd_tol = {name: _grad_tol(w) for name, w in zip(("dq", "dk", "dv"), want)}
        check(
            all(math.isfinite(e) and e <= bwd_tol[n] for n, e in bwd_err.items()),
            f"flash backward at head_dim {d}, 64x508x{h}: {bwd_err} past {bwd_tol}",
        )
        del want
        row = {
            "head_dim": d,
            "fwd_shape": f"256x508x{h}x{d} bf16", "fwd_ms": fwd_ms,
            "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
            "fwd_plain_ms": fwd_plain_ms, "fwd_library_ms": fwd_library_ms,
            "fwd_max_abs_err": fwd_err,
            "bwd_shape": f"64x508x{h}x{d} bf16", "dq_ms": dq_ms,
            "dq_bound_ms": dq_bound, "dq_bound_by": dq_by, "dkv_ms": dkv_ms,
            "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
            "bwd_plain_ms": bwd_plain_ms, "bwd_library_ms": bwd_library_ms,
            "bwd_max_abs_err": bwd_err, "bwd_tol": bwd_tol,
        }
        log_timing("C1 timing", row)
        rows[d] = row
        del q, k, v, do, out, lse, delta, dq, dk, dv, qt, kt, vt, dot, fo
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 15
C2_REF_SIZE = 32_768
# (R, S, B): the planes in global memory; past the old layout's 17,318-row
# limit at R = 2048.
C2_SHAPES = [(C2_REF_SIZE, 1, 256), (C2_REF_SIZE, 64, 8), (2048, 1, 17_408)]


def phase_c2(bundle_dir: Path) -> list[dict]:
    """``quant_fused`` past the shared-memory layout, against its plain
    version (exact counts and K-S), then timed."""
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
        kernel_route,
    )

    bundle = load_bundle(bundle_dir)
    dev = torch.device("cuda")
    columns, _ = generate_synthetic(40_000, seed=2)
    big = fit_monitor(Preprocessor.fit(columns).encode(columns),
                      drift_ref_size=C2_REF_SIZE).to(dev)
    monitors = {C2_REF_SIZE: big, 2048: bundle.monitor.to(dev)}
    qparams = {k: v.to(dev) for k, v in bundle.quant_params.items()}
    temp = torch.tensor(bundle.quant_temperature, dtype=torch.float32, device=dev)
    rows = []
    for n, (r, s, b) in enumerate(C2_SHAPES):
        mon = monitors[r]
        check(mon.num_ref_sorted.shape[1] == r, f"reference of {r} points expected")
        route = kernel_route(b, r)
        cat, num, mask = _ks_edge_inputs(bundle.preprocessor, mon.num_ref_sorted,
                                         s, b, 700 + n, dev)
        args = _core_args((qparams, mon, temp), cat, num, mask)
        got = fused_core_cuda(*args)
        again = fused_core_cuda(*args)
        torch.cuda.synchronize()
        want = fused_core_reference(*args)
        err = (got[0] - want[0]).abs().max().item()
        near = _near_threshold(mon, num, mask)
        flag_diff = ((got[1] != want[1]) & ~near).sum().item()
        exact = torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        work = None
        if route.workspace_words:
            work = torch.empty((s, 14, route.workspace_words), dtype=torch.int32, device=dev)
        launch, empty = _raw_launcher(args, got, s, b, r, work)
        ms = _graph_ms(launch)
        empty_ms = _graph_ms(empty)
        wrapper_ms = _event_ms(lambda: fused_core_cuda(*args), 20)
        plain_ms = _event_ms(lambda: fused_core_reference(*args), 3)
        bound_ms, bound_by = _bound(args, got, s, b, mask.sum(dim=1).tolist(), r)
        row = {
            "shape": f"{s}x{b}", "R": r, "slots": route.slots, "planes": route.planes,
            "smem_bytes": route.smem_bytes, "counts_ks_exact": exact,
            "preds_max_abs_err": err, "flag_mismatches": flag_diff,
            "two_launches_equal": repeat, "ms": ms, "empty_launch_ms": empty_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log_timing("C2", row)
        check(exact and err <= PRED_ATOL and flag_diff == 0 and repeat,
              f"quant_fused disagrees with its plain version past the layout: {row}")
        rows.append(row)
        del args, got, again, want, work
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 16
EXACT_MODELS = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(256, 256, 128), embed_dim=16),
    "mlp-ens8": dict(family="mlp", hidden_dims=(256, 256, 128), embed_dim=16,
                     ensemble_size=8),
}
EXACT_PRED_ATOL = 1.6e-2  # bf16 model: four ulps of a logit below 4, x 1/4
EXACT_DRIFT_ATOL = 1e-5  # p-values of the same statistics on two devices



def _seeded_exact_params(model, seed: int) -> None:
    """Seeded weights from numpy's generator: kernels N(0, 1/fan_in),
    embeddings N(0, 1), LayerNorm scales 1 + N(0, 0.01), biases
    N(0, 0.01); the ensemble's members differ."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if name.endswith("kernel"):
                vals = rng.normal(size=shape) / math.sqrt(shape[-2])
            elif name.endswith("embedding"):
                vals = rng.normal(size=shape)
            elif name.endswith("scale"):
                vals = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                vals = 0.1 * rng.normal(size=shape)
            p.copy_(torch.from_numpy(vals.astype(np.float32)))


def phase_exact_bundles(seed: int = 0) -> dict:
    """Full-width exact-tier bundles of each served model, written by the
    port (no JAX): the preprocessor and monitor fitted on 20,000 synthetic
    rows (R = 2048), seeded weights, a fitted-looking temperature."""
    from mlops_tpu_torch.bundle import save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.monitor.state import fit_monitor

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=2048)
    dirs = {}
    for k, (name, kw) in enumerate(EXACT_MODELS.items()):
        config = ModelConfig(precision="bf16", **kw)
        model = build_model(config)
        _seeded_exact_params(model, seed + k)
        directory = WORK / f"exact_{name}"
        shutil.rmtree(directory, ignore_errors=True)
        save_exact_bundle(
            directory, config, model, prep, monitor,
            calibration={"temperature": 1.2},
            tags={"source": "chip_smoke.py", "note": "seeded weights, not trained"},
        )
        n_params = sum(p.numel() for p in model.parameters())
        log(f"exact bundle {name}: {directory} ({n_params} params)")
        dirs[name] = directory
    return dirs


def _exact_programs(bundle, device):
    """The exact tier's packed programs with the bundle's state on
    ``device``."""
    import torch

    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
    )

    model = bundle.model.to(device).eval()
    state = (model_params(model), bundle.monitor.to(device),
             torch.tensor(bundle.temperature, dtype=torch.float32, device=device))
    return make_packed_predict_base(model), make_packed_grouped_base(model), state


def _monitor_statistics(mon, cat, num, mask):
    """The integer-valued statistics under the drift: category counts and
    the K-S statistics by the branch ``drift_scores`` takes."""
    import torch

    from mlops_tpu_torch.monitor.state import SMALL_KS_ROWS
    from mlops_tpu_torch.ops import drift

    counts = (torch.nn.functional.one_hot(cat.long(), mon.cat_ref_counts.shape[1])
              * mask[..., None, None]).sum(dim=-3)
    batch = num.float().transpose(-1, -2)
    if num.shape[-2] <= SMALL_KS_ROWS:
        ks = drift.ks_small_masked_statistic(
            mon.num_ref_sorted, mon.num_ref_cdf, batch, mask[..., None, :])
    else:
        ks = drift.ks_two_sample_masked(
            mon.num_ref_sorted, batch, mask[..., None, :].expand(batch.shape))[0]
    return counts, ks


def phase_exact_parity(dirs: dict, device: str = "cuda", geometries=None) -> dict:
    """Each model's packed programs on ``device`` against the port's CPU
    route at every bucket and group geometry (or at ``geometries``)."""
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.predict import packed_layout

    worst = {}
    for name, path in dirs.items():
        card = _exact_programs(load_bundle(path), device)
        cpu_bundle = load_bundle(path)
        cpu = _exact_programs(cpu_bundle, "cpu")
        prep = cpu_bundle.preprocessor
        mon_cpu = cpu[2][1]
        worst[name] = 0.0
        for k, (s, b) in enumerate(geometries or _geometries()):
            inputs = _inputs(prep, s, b, 900 + k, "cpu")
            if s == 1:
                inputs = tuple(t[0] for t in inputs)
            program = 0 if s == 1 else 1
            with torch.inference_mode():
                got, got_acc = card[program](
                    card[2][0], card[2][1], init_accumulator(device), card[2][2],
                    *(t.to(device) for t in inputs))
                want, want_acc = cpu[program](
                    cpu[2][0], cpu[2][1], init_accumulator("cpu"), cpu[2][2], *inputs)
                stats = [_monitor_statistics(mon, *(t.to(mon.out_mean.device) for t in inputs))
                         for mon in (card[2][1], mon_cpu)]
            got = got.cpu()
            p, o, d = packed_layout(b)
            pred_err = (got[..., p] - want[..., p]).abs().max().item()
            drift_err = (got[..., d] - want[..., d]).nan_to_num(0.0).abs().max().item()
            nan_same = torch.equal(got[..., d].isnan(), want[..., d].isnan())
            near = _near_threshold(mon_cpu, inputs[1], inputs[2])
            flag_diff = ((got[..., o] != want[..., o]) & ~near).sum().item()
            stats_exact = all(torch.equal(x.cpu(), y) for x, y in zip(*stats))
            # Rows and batches exact; outliers exact up to flags within the
            # threshold band, which may differ.
            counters = all(
                float(getattr(got_acc, f)) == float(getattr(want_acc, f))
                for f in ("rows", "batches")
            ) and abs(float(got_acc.outliers) - float(want_acc.outliers)) <= int(near.sum())
            worst[name] = max(worst[name], pred_err)
            ok = (pred_err <= EXACT_PRED_ATOL and drift_err <= EXACT_DRIFT_ATOL
                  and nan_same and flag_diff == 0 and stats_exact and counters)
            log(f"exact parity {name} S={s:2d} B={b:3d}: preds |err|={pred_err:.3g} "
                f"drift |err|={drift_err:.3g} flag mismatches={flag_diff} "
                f"counts/K-S exact={stats_exact} counters exact={counters}")
            check(ok, f"exact tier {name} on {device} disagrees with the CPU at S={s} B={b}")
    return {"max_pred_err": worst, "geometries": len(geometries or _geometries())}


def phase_exact_serve(dirs: dict, device: str = "cuda") -> dict:
    """The exact main path: ``serve`` at its default tier on the mlp-ens8
    bundle in a subprocess, then ``predict-file`` on it."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.commands import predict_file
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
    from mlops_tpu_torch.serve.engine import InferenceEngine

    path = dirs["mlp-ens8"]
    bundle = load_bundle(path)
    cpu = InferenceEngine(bundle, device="cpu")
    port = _free_port()
    server_log = WORK / "exact_server.log"
    bodies = {
        "golden": json.loads((ROOT / "tests/golden/sample-request.json").read_text()),
        "5": _records(5, 31), "64": _records(64, 32, drift=0.5), "256": _records(256, 33),
    }
    with open(server_log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={path}", f"serve.port={port}",
             "serve.host=127.0.0.1", f"serve.device={device}"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=out, stderr=subprocess.STDOUT,
        )
    try:
        deadline = time.monotonic() + 600
        while True:
            check(proc.poll() is None,
                  f"exact server exited early ({proc.returncode}); see {server_log}")
            try:
                if _http(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "exact server never became ready")
            time.sleep(0.5)
        _, text = _http(port, "GET", "/metrics")
        launches_before = _metric(text.decode(), "mlops_tpu_kernel_launches_total")
        worst = 0.0
        for name, records in bodies.items():
            status, body = _http(port, "POST", "/predict", json.dumps(records).encode())
            check(status == 200, f"exact /predict {name} answered {status}: {body[:200]}")
            got, want = json.loads(body), cpu.predict_records(records)
            check(len(got["predictions"]) == len(records)
                  and all(math.isfinite(x) for x in got["predictions"]),
                  f"exact {name}: not {len(records)} finite predictions")
            worst = max(worst, _compare_exact(got, want, bundle, records, f"exact http {name}"))
        _, text = _http(port, "GET", "/metrics")
        text = text.decode()
        rows = _metric(text, "mlops_tpu_rows_scored_total")
        launched = _metric(text, "mlops_tpu_kernel_launches_total") - launches_before
        sent = sum(len(r) for r in bodies.values())
        check(rows == sent, f"exact /metrics rows {rows} != records sent {sent}")
        check(launched == 0, f"the exact tier launched quant_fused {launched} times")
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=120) == 0, "exact server did not exit 0 after SIGTERM")
        text = server_log.read_text()
        check("tier=exact" in text and "drained; exiting" in text,
              "exact server: no 'tier=exact' or no clean drain in its log")
        log("exact http: served on the default tier (exact), drained cleanly")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    columns, _ = generate_synthetic(300, seed=34, drift=0.2)
    csv = WORK / "exact_rows.csv"
    write_csv_columns(csv, columns)
    args = [f"data.train_path={csv}", f"serve.model_directory={path}"]
    here = predict_file(load_config(args + [f"serve.device={device}"]))
    there = predict_file(load_config(args + ["serve.device=cpu"]))
    records = [{k: columns[k][i] for k in columns} for i in range(300)]
    gap = _compare_exact(here, there, bundle, records, "exact predict-file")
    check(len(here["predictions"]) == 300 and np.isfinite(here["predictions"]).all(),
          "exact predict-file: not 300 finite predictions")
    return {"http_max_pred_err": worst, "predict_file_max_pred_err": gap}


def _compare_exact(got: dict, want: dict, bundle, records, what: str) -> float:
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    p_err = float(np.abs(np.asarray(got["predictions"]) - np.asarray(want["predictions"])).max())
    d_err = float(np.abs(np.asarray(list(got["feature_drift_batch"].values()))
                         - np.asarray(list(want["feature_drift_batch"].values()))).max())
    ds = bundle.preprocessor.encode(records_to_columns(records))
    near = _near_threshold(bundle.monitor, torch.from_numpy(ds.numeric),
                           torch.ones(len(records), dtype=torch.bool))
    diff = np.asarray(got["outliers"]) != np.asarray(want["outliers"])
    flag_diff = int((diff & ~near.numpy()).sum())
    log(f"{what}: preds |err|={p_err:.3g} drift |err|={d_err:.3g} flag mismatches={flag_diff}")
    check(p_err <= EXACT_PRED_ATOL + 1e-6 and d_err <= EXACT_DRIFT_ATOL + 1e-6
          and flag_diff == 0, f"{what}: disagrees with the CPU route")
    return p_err


def _dispatch_call(engine, prep, s: int, b: int, seed: int):
    """One dispatch -> fetch round trip as a call returning the fetched
    arrays (``fetch_arrays_raw`` / ``fetch_group_raw``): a solo request
    of ``b`` rows or a group of ``s`` requests (``_inputs``' rows and
    mask)."""
    cat, num, mask = (t.numpy() for t in _inputs(prep, s, b, seed, "cpu"))
    if s == 1:
        m = int(mask[0].sum())
        return lambda: engine.fetch_arrays_raw(
            engine.dispatch_arrays(cat[0, :m], num[0, :m]))
    parts = [(cat[i, : mask[i].sum()], num[i, : mask[i].sum()])
             for i in range(s) if mask[i].any()]
    return lambda: engine.fetch_group_raw(engine.dispatch_group_arrays(parts))[1:]


def _dispatch_fetch_p50(engine, prep, s: int, b: int, seed: int, n: int = 100) -> float:
    """Host wall ms of one dispatch -> fetch round trip (median of ``n``)
    for a solo request of ``b`` rows or a group of ``s`` requests."""
    import numpy as np

    call = _dispatch_call(engine, prep, s, b, seed)
    for _ in range(10):
        call()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_exact_timing(dirs: dict) -> list[dict]:
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    rows = []
    for name, path in dirs.items():
        bundle = load_bundle(path)
        engine = InferenceEngine(bundle, device="cuda")
        engine.warmup()
        row = {"model": name, "tier": engine.serve_tier,
               "warmup_s": engine.warmup_stats["warmup_s"]}
        for s, b in ((1, 1), (1, 256), (64, 1), (64, 8)):
            row[f"dispatch_fetch_ms_p50_{s}x{b}"] = _dispatch_fetch_p50(
                engine, bundle.preprocessor, s, b, 950 + s + b)
        log_timing("exact timing", row)
        rows.append(row)
    return rows


# ----------------------------------------------------------------- phase 18
EXACT_JOB_TOML = "configs/train_register_job.toml"
# The exact tier's families at full width: the job's model (mlp, hidden
# 256/256/128, embed 16, bf16, the config's defaults), its 8-member
# ensemble, the FT-Transformer and the single-record BERT at the config's
# defaults (token_dim 64, depth 3, 8 heads), and the linear floor. The
# ensemble and the transformers ship a bulk student unless
# train.distill_bulk is off; these runs turn it off to time the trainer
# alone (phase 23 trains the students).
EXACT_TRAIN_FAMILIES = {
    "mlp": [],
    "mlp-ens8": ["model.ensemble_size=8", "train.distill_bulk=false"],
    "ft_transformer": ["model.family=ft_transformer", "train.distill_bulk=false"],
    "bert": ["model.family=bert", "train.distill_bulk=false"],
    "linear": ["model.family=linear"],
}
EXACT_CURVE_BATCH = 64  # phase 18's curves: the CPU side runs them too
EXACT_CURVE_STEPS = 25  # cut from 50 to keep the run in its time limit
EXACT_CUT_STEPS = 200  # of the job's 2,000, for mlp-ens8, ft_transformer, bert
EXACT_CUT_EVAL_EVERY = 100  # of the job's 200
# The trained bundles on the card against the CPU route: solo buckets 1
# and 256, groups 64x1 and 64x8 (phase 16 checks every geometry).
EXACT_TRAINED_GEOMETRIES = [(1, 1), (1, 256), (64, 1), (64, 8)]
EXACT_AUC_STEPS = 50  # cut from 200 to keep the run in its time limit
EXACT_AUC_GAP = 0.01


def _job_config(extra, device: str):
    from mlops_tpu_torch.config import load_config

    return load_config([*extra, f"train.device={device}"], ROOT / EXACT_JOB_TOML)


def _exact_split(config):
    """The job's data as ``run_training`` reads it: ``data.rows``
    synthetic rows from ``data.seed``, the preprocessor fitted on them,
    the seed-2024 split."""
    from mlops_tpu_torch.data import Preprocessor
    from mlops_tpu_torch.train.pipeline import load_training_data, split_dataset

    columns, labels = load_training_data(config)
    ds = Preprocessor.fit(columns).encode(columns, labels)
    return split_dataset(ds, config.data.valid_fraction)


def _tensors(ds, device):
    import numpy as np
    import torch

    return (torch.from_numpy(ds.cat_ids).to(device), torch.from_numpy(ds.numeric).to(device),
            torch.from_numpy(np.asarray(ds.labels, np.float32)).to(device))


def phase_exact_train_parity(families=None, extra: tuple[str, ...] = (),
                             batch: int = EXACT_CURVE_BATCH,
                             steps: int = EXACT_CURVE_STEPS, device: str = "cuda") -> dict:
    """Each family at full width, dropout 0, the same seeded init on the
    card and on the CPU: one step's gradients at the job's batch, leaf by
    leaf (cosine >= 0.98, norm ratio within 5 %), then ``steps`` steps of
    ``batch`` rows each way on the same batches (loss curves within 0.05,
    0.02 on average). ``extra`` overrides and ``device="cpu"`` rehearse it
    small on the CPU."""
    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train import loop

    families = families or EXACT_TRAIN_FAMILIES
    out = {}
    train_ds = None
    for name, fam_extra in families.items():
        config = _job_config([*fam_extra, "model.dropout=0.0", f"train.steps={steps}",
                              *extra], device)
        if train_ds is None:
            train_ds, _ = _exact_split(config)
            host = _tensors(train_ds, "cpu")
            n = host[0].shape[0]
        models = {dev: init_params(build_model(config.model), 0).to(dev)
                  for dev in (device, "cpu")}

        def batch_of(step, dev, rows=batch):
            idx = torch.from_numpy(loop.batch_indices(n, rows, 0, step))
            return tuple(t[idx].to(dev) for t in host)

        grads = {}
        for dev, model in models.items():
            loss = loop.training_loss(model, *batch_of(1, dev, config.train.batch_size),
                                      None, config.train.pos_weight)
            loss.backward()
            grads[dev] = {k: p.grad.float().cpu().flatten() for k, p in model.named_parameters()}
        stats = []
        for k, want in grads["cpu"].items():
            got = grads[device][k]
            cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
            ratio = (got.norm() / want.norm().clamp_min(1e-30)).item()
            stats.append((k, cos, ratio))
            check(cos >= GRAD_COSINE_MIN and abs(ratio - 1) <= GRAD_NORM_RTOL,
                  f"{name} {k}: card vs CPU gradient cosine {cos:.5f}, norm ratio {ratio:.5f}")
        curves = {}
        for dev, model in models.items():
            opt = loop.make_optimizer(model, config.train)
            curves[dev] = [
                float(loop.train_step(model, opt, config.train, s, *batch_of(s, dev)))
                for s in range(1, steps + 1)
            ]
        gaps = [abs(a - b) for a, b in zip(curves[device], curves["cpu"])]
        row = {
            "grad_batch": config.train.batch_size, "curve_batch": batch, "steps": steps,
            "params": sum(p.numel() for p in models["cpu"].parameters()),
            "worst_cosine": min(s[1] for s in stats),
            "worst_norm_ratio": max((s[2] for s in stats), key=lambda r: abs(r - 1)),
            "max_gap": max(gaps), "mean_gap": sum(gaps) / len(gaps),
            "first_loss": curves[device][0], "last_loss": curves[device][-1],
        }
        log(f"exact train parity {name} {json.dumps(row)}")
        check(all(math.isfinite(v) for c in curves.values() for v in c),
              f"{name}: non-finite training loss")
        check(row["max_gap"] <= CURVE_MAX_GAP and row["mean_gap"] <= CURVE_MEAN_GAP,
              f"{name}: card and CPU loss curves part: {row}")
        out[name] = row
        del models, grads
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 19
def _start_train_cli(name: str, extra, root: Path, device: str, command: str = "train"):
    """``python -m mlops_tpu_torch train --config <job>`` (or another
    ``command`` of the job's config) in a subprocess, started;
    ``_finish_train_cli`` waits for it."""
    log_path = root / f"{name}.log"
    root.mkdir(parents=True, exist_ok=True)
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlops_tpu_torch", command, "--config", EXACT_JOB_TOML,
         *extra, f"registry.root={root / 'registry'}", f"registry.run_root={root / 'runs'}",
         f"registry.run_name={name}", f"train.device={device}"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=out, text=True,
    )
    return proc, out, log_path, time.perf_counter()


def _finish_train_cli(name: str, extra, started, device: str) -> tuple[dict, float]:
    """The started run's JSON line checked against its metrics.jsonl (one
    row per window, the packaged step the best validation AUC's)."""
    proc, err, log_path, t0 = started
    try:
        stdout, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"train {name} exited {proc.returncode}: {log_path.read_text()[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    config = _job_config(extra, device)
    steps, every = config.train.steps, max(1, min(config.train.eval_every, config.train.steps))
    log(f"train {name}: {wall:.1f} s: {json.dumps(out)}")
    check(set(out) == {"bundle", "model_uri", "run_dir", "steps", "packaged_step", "metrics"},
          f"train {name} printed keys {sorted(out)}")
    check(out["steps"] == steps, f"train {name} trained {out['steps']} steps, not {steps}")
    check(len(out["metrics"]) == 5 and all(math.isfinite(v) for v in out["metrics"].values()),
          f"train {name} metrics {out['metrics']}")
    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    want_steps = list(range(every, steps + 1, every))
    if want_steps[-1] != steps:
        want_steps.append(steps)
    check([r["step"] for r in rows] == want_steps,
          f"train {name} metrics.jsonl steps {[r['step'] for r in rows]}")
    best = max(rows, key=lambda r: r["validation_roc_auc_score"])
    check(out["packaged_step"] == best["step"] and out["metrics"] == {
        k: v for k, v in best.items() if k.startswith("validation_")},
        f"train {name}: packaged step {out['packaged_step']}, best row {best['step']}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    check(manifest["flavor"] == "flax" and manifest["calibration"]["temperature"] > 0,
          f"train {name}: not a calibrated flax bundle")
    return out, wall


def _serve_cmd(path, port: int, device: str) -> tuple[list[str], dict]:
    """``python -m mlops_tpu_torch serve`` on ``path`` at ``port``."""
    return _cli(["serve", f"serve.model_directory={path}", f"serve.port={port}",
                 "serve.host=127.0.0.1", f"serve.device={device}"]), {}


def _serve_golden(bundles: dict, device: str, launch=_serve_cmd,
                  bodies: tuple[list[dict], ...] = (), env_by_name=None) -> dict:
    """``serve`` on each bundle at once (the default tier, exact), the
    golden request and ``bodies`` to each, compared with the CPU route on
    the bundle's directory; no kernel launches; each drains on SIGTERM.
    ``launch(path, port, device)`` gives the server's command and the
    environment it adds; ``env_by_name`` adds more to one server's."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    golden = json.loads((ROOT / "tests/golden/sample-request.json").read_text())
    procs = {}
    for name, path in bundles.items():
        port = _free_port()
        out = open(WORK / f"exact_train_server_{name}.log", "wb")
        cmd, env = launch(path, port, device)
        env = {**env, **(env_by_name or {}).get(name, {})}
        procs[name] = (port, out, subprocess.Popen(
            cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), **env),
            stdout=out, stderr=subprocess.STDOUT,
        ))
    worst = {}
    try:
        for name, (port, _, proc) in procs.items():
            deadline = time.monotonic() + 600
            while True:
                check(proc.poll() is None, f"{name} server exited early ({proc.returncode})")
                try:
                    if _http(port, "GET", "/healthz/ready")[0] == 200:
                        break
                except OSError:
                    pass
                check(time.monotonic() < deadline, f"{name} server never became ready")
                time.sleep(0.5)
            bundle = load_bundle(bundles[name])
            cpu = InferenceEngine(bundle, device="cpu")
            worst[name] = 0.0
            for records in (golden, *bodies):
                status, body = _http(port, "POST", "/predict", json.dumps(records).encode())
                check(status == 200, f"{name} /predict answered {status}: {body[:200]}")
                worst[name] = max(worst[name], _compare_exact(
                    json.loads(body), cpu.predict_records(records), bundle, records,
                    f"trained {name} http, {len(records)} records"))
            _, text = _http(port, "GET", "/metrics")
            check(_metric(text.decode(), "mlops_tpu_kernel_launches_total") == 0,
                  f"{name}: the exact tier launched a kernel")
        for name, (port, out, proc) in procs.items():
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=120) == 0, f"{name} server did not exit 0 after SIGTERM")
            check("tier=exact" in (WORK / f"exact_train_server_{name}.log").read_text(),
                  f"{name} server did not serve the exact tier")
    finally:
        for _, out, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    return worst


def phase_exact_train_path(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """The exact tier's training main path: the job in a subprocess at
    its full config (mlp), then mlp-ens8, ft_transformer and bert with
    the steps cut; every bundle on the card against the CPU route at
    every bucket and group geometry and over HTTP; then ``fit`` of the
    mlp config in this process for EXACT_AUC_STEPS steps on the card and on the CPU
    on the same batches (validation AUCs within 0.01), with the kernel
    launch counts set to 0 just before and read after. ``extra`` and
    ``device="cpu"`` rehearse it small on the CPU."""
    import torch

    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.ops import quant_kernel
    from mlops_tpu_torch.train import loop

    root = WORK / "exact_train"
    shutil.rmtree(root, ignore_errors=True)
    cut = [f"train.steps={EXACT_CUT_STEPS}", f"train.eval_every={EXACT_CUT_EVAL_EVERY}"]
    runs = {name: [*fam_extra, *(cut if name != "mlp" else []), *extra]
            for name, fam_extra in EXACT_TRAIN_FAMILIES.items() if name != "linear"}
    config = _job_config(list(extra), device)
    log(f"exact train: {EXACT_JOB_TOML} (rows {config.data.rows}, batch "
        f"{config.train.batch_size}, {config.train.steps} steps, eval every "
        f"{config.train.eval_every}, {config.model.family} {config.model.hidden_dims} "
        f"{config.model.precision}, pos_weight {config.train.pos_weight}); mlp-ens8, "
        f"ft_transformer and bert cut to {' '.join(cut)} (widths the config's)")
    # The job alone (its wall is the time a retraining job holds the
    # card), then the three cut runs at once.
    clis, walls = {}, {}
    clis["mlp"], walls["mlp"] = _finish_train_cli(
        "mlp", runs["mlp"], _start_train_cli("mlp", runs["mlp"], root, device), device)
    started = {name: _start_train_cli(name, args, root, device)
               for name, args in runs.items() if name != "mlp"}
    try:
        for name, run in started.items():
            clis[name], walls[name] = _finish_train_cli(name, runs[name], run, device)
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    bundles = {name: Path(out["bundle"]) for name, out in clis.items()}
    parity = phase_exact_parity(bundles, device, EXACT_TRAINED_GEOMETRIES)
    http = _serve_golden(bundles, device)

    train_ds, valid_ds = _exact_split(config)
    cfg = dataclasses.replace(config.train, steps=EXACT_AUC_STEPS, eval_every=EXACT_AUC_STEPS)
    _reset_launch_counts()
    quant_kernel.quant_kernel_launches.reset()
    fits = {dev: loop.fit(build_model(config.model), train_ds, valid_ds, cfg, device=dev)
            for dev in (device, "cpu")}
    launches = (*_launch_counts(), quant_kernel.quant_kernel_launches.value)
    aucs = {dev: r.metrics["validation_roc_auc_score"] for dev, r in fits.items()}
    log(f"exact train in process, {EXACT_AUC_STEPS} steps: validation AUC {aucs}; "
        f"kernel launches flash fwd/dq/dkv/quant_fused {launches}")
    check(launches == (0, 0, 0, 0), f"the dense trainer launched kernels {launches}")
    check(abs(aucs[device] - aucs["cpu"]) <= EXACT_AUC_GAP,
          f"card and CPU validation AUCs part: {aucs}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return {
        "cli": {name: {"steps": out["steps"], "packaged_step": out["packaged_step"],
                       "metrics": out["metrics"], "wall_s": walls[name]}
                for name, out in clis.items()},
        "bundle_parity": parity, "golden_http_max_pred_err": http,
        "auc_card_vs_cpu": aucs, "launches": launches,
    }


# ----------------------------------------------------------------- phase 20
TIMED_WINDOWS = 4  # the host paces these steps: its jitter shows as spread (cut from 8)
TIMED_STEPS = 15  # per window
PROFILED_STEPS = 5


def phase_exact_train_timing(cli_walls: dict) -> list[dict]:
    """Each family's training step at the job's batch on the card: step
    ms (CUDA events around each of 4 windows of 15 steps after 5 of
    warm-up, with the host clock around the same windows; the median
    window, and the fastest and slowest), rows trained per second at the
    median, and under ``torch.profiler`` over 5 steps the device kernels
    per step and the device's busy time, as a share of the median
    unprofiled wall."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train import loop

    rows = []
    data = None
    for name, fam_extra in EXACT_TRAIN_FAMILIES.items():
        config = _job_config(fam_extra, "cuda")
        if data is None:
            data = _tensors(_exact_split(config)[0], "cuda")
            n = data[0].shape[0]
        batch = config.train.batch_size
        model = init_params(build_model(config.model), 0).to("cuda")
        opt = loop.make_optimizer(model, config.train)
        idx = torch.from_numpy(
            np.stack([loop.batch_indices(n, batch, 0, s) for s in range(1, 41)])
        ).to("cuda")
        count = [0]

        def step():
            count[0] += 1
            i = idx[count[0] % 40]
            loop.train_step(model, opt, config.train, count[0], *(t[i] for t in data))

        for _ in range(5):
            step()
        torch.cuda.synchronize()
        windows, walls = [], []
        for _ in range(TIMED_WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(TIMED_STEPS):
                step()
            end.record()
            end.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
            windows.append(start.elapsed_time(end) / TIMED_STEPS)
        step_ms, wall_ms = float(np.median(windows)), float(np.median(walls))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy_us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in device)
        busy_ms = busy_us / 1e3 / PROFILED_STEPS
        row = {
            "model": name, "batch": batch, "precision": config.model.precision,
            "params": sum(p.numel() for p in model.parameters()),
            "step_ms": step_ms, "step_ms_min": min(windows),
            "step_ms_max": max(windows), "windows": TIMED_WINDOWS,
            "steps_per_window": TIMED_STEPS,
            "rows_per_s": batch / step_ms * 1e3,
            "wall_ms_per_step_unprofiled": wall_ms,
            "device_kernels_per_step": sum(e.count for e in device) / PROFILED_STEPS,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "cli_wall_s": cli_walls.get(name),
        }
        log_timing("exact train timing", row)
        rows.append(row)
        del model, opt
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 21
ROUTE_SHAPES = [(1, 1), (1, 256), (64, 1), (64, 8)]
ROUTE_ROUNDS = 2  # eager and graph take turns, this many times each (cut from 4 to keep
# the run in its time limit)
ROUTE_ITERS = 12  # dispatches per turn (cut from 25)
ROUTE_PROFILED = 10  # dispatches per route under torch.profiler
_KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx")


def _route_profile(call, n: int) -> dict:
    """``n`` calls under ``torch.profiler``: the host's CUDA API calls
    per dispatch (kernel launches, graph launches, all), the device ops
    per dispatch and the device's busy share of the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    api = {e.key: e.count for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith(("cuda", "cu"))}
    busy_s = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in device) / 1e6
    return {
        "kernel_launch_calls": sum(api.get(k, 0) for k in _KERNEL_LAUNCH_CALLS) / n,
        "graph_launch_calls": api.get("cudaGraphLaunch", 0) / n,
        "cuda_api_calls": sum(api.values()) / n,
        "device_ops": sum(e.count for e in device) / n,
        "device_busy_share": busy_s / wall_s,
    }


def phase_dispatch_routes(bundle_dir: Path, dirs: dict) -> list[dict]:
    """Eager against CUDA-graph dispatch on the card, in one call and in
    turns: for the quant bundle (quant tier) and the linear, mlp and
    mlp-ens8 bundles (exact tier), an engine of each route, and at bucket
    1, bucket 256 and groups 64x1, 64x8 the packed outputs of the two
    routes (bitwise equal), dispatch -> fetch p50 and p99 over
    ROUTE_ROUNDS x ROUTE_ITERS round trips a route with the spread of the
    turns' p50s, and each route's profile (``_route_profile``)."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    models = {"quant": (bundle_dir, "quant"),
              **{name: (path, "exact") for name, path in dirs.items()}}
    rows = []
    for name, (path, tier) in models.items():
        bundle = load_bundle(path)
        engines = {"eager": InferenceEngine(bundle, serve_tier=tier, cuda_graphs=False),
                   "graph": InferenceEngine(bundle, serve_tier=tier)}
        for engine in engines.values():
            engine.warmup()
        stats = engines["graph"].warmup_stats
        row = {"model": name, "tier": tier, "capture_s": stats["capture_s"],
               "graph_pool_bytes": stats["graph_pool_bytes"],
               "graphs": stats["programs"]}
        for k, (s, b) in enumerate(ROUTE_SHAPES):
            calls = {route: _dispatch_call(e, bundle.preprocessor, s, b, 970 + k)
                     for route, e in engines.items()}
            outs = {route: call() for route, call in calls.items()}
            same = all(np.array_equal(e.view(np.uint64), g.view(np.uint64))
                       for e, g in zip(outs["eager"], outs["graph"]))
            check(same, f"{name} {s}x{b}: graph replay differs from the eager program")
            for call in calls.values():
                for _ in range(5):
                    call()
            times = {route: [] for route in calls}
            turns = {route: [] for route in calls}
            for r in range(ROUTE_ROUNDS):
                for route in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
                    t = []
                    for _ in range(ROUTE_ITERS):
                        t0 = time.perf_counter()
                        calls[route]()
                        t.append((time.perf_counter() - t0) * 1e3)
                    times[route] += t
                    turns[route].append(float(np.median(t)))
            row[f"{s}x{b}"] = {
                route: {
                    "p50_ms": float(np.percentile(times[route], 50)),
                    "p99_ms": float(np.percentile(times[route], 99)),
                    "turn_p50_ms_min": min(turns[route]),
                    "turn_p50_ms_max": max(turns[route]),
                    **_route_profile(calls[route], ROUTE_PROFILED),
                }
                for route in calls
            }
            row[f"{s}x{b}"]["bitwise_equal"] = same
        log_timing("dispatch routes", row)
        rows.append(row)
    return rows


# ----------------------------------------------------------------- phase 22
BURST_REQUESTS = 400  # phases 29, 33 and 35 (cut from 2,000)
BURST_SERVER_REQUESTS = 600  # phase 22 (cut from 2,000 to keep the run in its time limit)
BURST_CONCURRENCY = (1, 16, 64)
BURST_CHEAP_EVERY = 4  # every 4th request asks for x-slo-class: cheap


def phase_burst_bundle(dirs: dict) -> Path:
    """The mlp-ens8 bundle with a gated quant student beside its exact
    tier (seeded student weights)."""
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student

    bundle = load_bundle(dirs["mlp-ens8"])
    directory = WORK / "exact_mlp-ens8_quant"
    shutil.rmtree(directory, ignore_errors=True)
    save_exact_bundle(
        directory, bundle.model_config, bundle.model, bundle.preprocessor,
        bundle.monitor, calibration={"temperature": bundle.temperature},
        quant_params=quantize_student(init_quant_master(1)),
        quant={"fidelity": {}, "temperature": 1.0, "gates": {
            "passed": True,
            "note": "seeded weights, not distilled: this bundle checks "
            "parity, not quality"}},
        tags={"source": "chip_smoke.py"},
    )
    return directory


def _burst_set(bundle, cpu, kind: str, seed: int, n: int = BURST_REQUESTS) -> dict:
    """``n`` requests (``single``: one record each; ``mixed``:
    1..8), their bodies and headers, and what the CPU route answers each
    (grouped 64 at a time, tier by tier), with the tolerances of phases
    5 and 16 and each request's rows off the flag threshold band."""
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    rng = np.random.default_rng(seed)
    sizes = np.ones(n, int) if kind == "single" else rng.integers(1, 9, size=n)
    pool = _records(int(sizes.sum()), seed, drift=0.3)
    bounds = np.cumsum([0, *sizes])
    requests = [pool[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    cheap = [i % BURST_CHEAP_EVERY == 0 for i in range(n)]
    wants = [None] * n
    for tier in (True, False):
        idx = [i for i in range(n) if cheap[i] == tier]
        for lo in range(0, len(idx), 64):
            chunk = idx[lo:lo + 64]
            got = cpu.predict_group([requests[i] for i in chunk],
                                    tier="quant" if tier else None)
            for i, want in zip(chunk, got):
                wants[i] = want
    ds = bundle.preprocessor.encode(records_to_columns(pool))
    near = _near_threshold(bundle.monitor, torch.from_numpy(ds.numeric),
                           torch.ones(len(pool), dtype=torch.bool)).numpy()
    return {
        "kind": kind,
        "bodies": [json.dumps(r).encode() for r in requests],
        "headers": ["x-slo-class: cheap\r\n" if c else "" for c in cheap],
        "rows": int(sizes.sum()),
        "cheap": sum(cheap),
        "want": [(np.asarray(w["predictions"]),
                  np.asarray(list(w["feature_drift_batch"].values())),
                  np.asarray(w["outliers"])) for w in wants],
        "off_band": [~near[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])],
        "tol": [(PRED_ATOL, DRIFT_ATOL) if c else
                (EXACT_PRED_ATOL + 1e-6, EXACT_DRIFT_ATOL + 1e-6) for c in cheap],
    }


async def _burst_client(port: int, burst: dict, order, out: list, lat: list) -> None:
    """One keep-alive connection sending requests of ``burst`` as
    ``order`` hands them out, recording each answer and its latency."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        for i in order:
            body = burst["bodies"][i]
            head = (f"POST /predict HTTP/1.1\r\nhost: localhost\r\n"
                    f"content-type: application/json\r\n{burst['headers'][i]}"
                    f"content-length: {len(body)}\r\n\r\n").encode()
            t0 = time.perf_counter()
            writer.write(head + body)
            status = int((await reader.readline()).split()[1])
            length = 0
            while (line := await reader.readline()) not in (b"\r\n", b""):
                name, _, value = line.decode("latin1").partition(":")
                if name.strip().lower() == "content-length":
                    length = int(value)
            payload = await reader.readexactly(length)
            lat[i] = (time.perf_counter() - t0) * 1e3
            out[i] = (status, payload)
    finally:
        writer.close()


def _run_burst(port: int, burst: dict, concurrency: int) -> tuple[list, list, float]:
    import asyncio

    n = len(burst["bodies"])
    out, lat = [None] * n, [0.0] * n
    order = iter(range(n))

    async def main():
        await asyncio.gather(*(_burst_client(port, burst, order, out, lat)
                               for _ in range(concurrency)))

    t0 = time.perf_counter()
    asyncio.run(main())
    return out, lat, time.perf_counter() - t0


def _check_burst(burst: dict, out: list, what: str) -> dict:
    import numpy as np

    worst = {"pred": 0.0, "drift": 0.0}
    for i, (status, payload) in enumerate(out):
        check(status == 200, f"{what}: request {i} answered {status}: {payload[:200]}")
        got = json.loads(payload)
        preds, drift, flags = burst["want"][i]
        p_tol, d_tol = burst["tol"][i]
        p_err = float(np.abs(np.asarray(got["predictions"]) - preds).max())
        d_err = float(np.abs(np.asarray(list(got["feature_drift_batch"].values()))
                             - drift).max())
        off = burst["off_band"][i]
        flag_diff = int((np.asarray(got["outliers"])[off] != flags[off]).sum())
        check(p_err <= p_tol and d_err <= d_tol and flag_diff == 0,
              f"{what}: request {i} disagrees with the CPU route "
              f"(preds {p_err:.3g}, drift {d_err:.3g}, flags {flag_diff})")
        worst["pred"] = max(worst["pred"], p_err)
        worst["drift"] = max(worst["drift"], d_err)
    return worst


def _scrape(port: int) -> dict:
    """The /metrics numbers the burst phase reads: rows, demotions, kernel
    launches and dispatches (all, grouped, quant-tier)."""
    _, text = _http(port, "GET", "/metrics")
    text = text.decode()
    out = {"rows": _metric(text, "mlops_tpu_rows_scored_total"),
           "demotions": _metric(text, "mlops_tpu_tier_demotions_total"),
           "launches": _metric(text, "mlops_tpu_kernel_launches_total"),
           "dispatches": 0.0, "group_dispatches": 0.0, "quant_dispatches": 0.0}
    for line in text.splitlines():
        if line.startswith("mlops_tpu_dispatches_total{"):
            entry = line.split('"')[1]
            n = float(line.rsplit(" ", 1)[1])
            out["dispatches"] += n
            out["group_dispatches"] += n * entry.startswith("group_")
            out["quant_dispatches"] += n * entry.endswith("@quant")
    return out


def phase_burst(bundle_dir: Path, device: str = "cuda") -> list[dict]:
    """Concurrent traffic through the micro-batcher on the main path:
    ``python -m mlops_tpu_torch serve serve.tier_routing=true`` on the
    exact mlp-ens8 bundle with a gated quant tier, twice in subprocesses
    (the batcher on, as configured by default, and off with
    ``serve.batch_window_ms=0``). Each takes BURST_SERVER_REQUESTS
    single-record and BURST_SERVER_REQUESTS mixed 1..8-record requests (every
    BURST_CHEAP_EVERY-th asking for the cheap class, so the quant tier)
    at each of BURST_CONCURRENCY keep-alive connections, servers in
    turns. Every answer agrees with the CPU route; /metrics rows equal
    the records sent, no default-class request was demoted, the
    quant_fused launches equal the quant-tier dispatches, and at
    concurrency 64 the batcher makes fewer dispatches than requests.
    Logs requests/s, latency p50/p99 and dispatches (grouped ones too)
    per request."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    bundle = load_bundle(bundle_dir)
    cpu = InferenceEngine(bundle, device="cpu", tier_routing=True)
    bursts = [_burst_set(bundle, cpu, kind, seed, BURST_SERVER_REQUESTS)
              for kind, seed in (("single", 41), ("mixed", 42))]
    modes = {"batcher": [], "window_0": ["serve.batch_window_ms=0"]}
    servers = {}
    for mode, extra in modes.items():
        port = _free_port()
        out = open(WORK / f"burst_server_{mode}.log", "wb")
        servers[mode] = (port, out, subprocess.Popen(
            [sys.executable, "-m", "mlops_tpu_torch", "serve",
             f"serve.model_directory={bundle_dir}", f"serve.port={port}",
             "serve.host=127.0.0.1", f"serve.device={device}",
             "serve.tier_routing=true", *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=out, stderr=subprocess.STDOUT,
        ))
    rows = []
    try:
        for mode, (port, _, proc) in servers.items():
            deadline = time.monotonic() + 600
            while True:
                check(proc.poll() is None, f"burst server {mode} exited early "
                      f"({proc.returncode}); see {WORK}/burst_server_{mode}.log")
                try:
                    if _http(port, "GET", "/healthz/ready")[0] == 200:
                        break
                except OSError:
                    pass
                check(time.monotonic() < deadline, f"burst server {mode} never became ready")
                time.sleep(0.5)
        for burst in bursts:
            for concurrency in BURST_CONCURRENCY:
                for mode, (port, _, _) in servers.items():
                    before = _scrape(port)
                    out, lat, wall = _run_burst(port, burst, concurrency)
                    what = f"burst {burst['kind']} c={concurrency} {mode}"
                    worst = _check_burst(burst, out, what)
                    # A scrape that finds the single-flight monitor fetch
                    # still in flight renders that fetch's (older) snapshot:
                    # poll until the rows land, exact, as phase 29 does.
                    after = _await_rows(port, before, burst["rows"], what)
                    d = {k: after[k] - before[k] for k in before}
                    check(d["demotions"] == 0, f"{what}: {d['demotions']} demotions")
                    expected = d["quant_dispatches"] if device == "cuda" else 0
                    check(d["launches"] == expected,
                          f"{what}: {d['launches']} quant_fused launches for "
                          f"{d['quant_dispatches']} quant-tier dispatches")
                    if mode == "batcher" and concurrency == 64:
                        check(d["dispatches"] < BURST_SERVER_REQUESTS,
                              f"{what}: {d['dispatches']} dispatches, nothing coalesced")
                    row = {
                        "kind": burst["kind"], "concurrency": concurrency, "mode": mode,
                        "requests": BURST_SERVER_REQUESTS, "records": burst["rows"],
                        "cheap_requests": burst["cheap"],
                        "requests_per_s": BURST_SERVER_REQUESTS / wall,
                        "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "dispatches_per_request": d["dispatches"] / BURST_SERVER_REQUESTS,
                        "grouped_dispatches_per_request":
                            d["group_dispatches"] / BURST_SERVER_REQUESTS,
                        "quant_dispatches": d["quant_dispatches"],
                        "quant_fused_launches": d["launches"],
                        "max_pred_err": worst["pred"], "max_drift_err": worst["drift"],
                    }
                    log_timing("burst", row)
                    rows.append(row)
        for mode, (port, _, proc) in servers.items():
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=120) == 0, f"burst server {mode} did not exit 0")
            text = (WORK / f"burst_server_{mode}.log").read_text()
            check("tiers=quant,exact" in text and "drained; exiting" in text,
                  f"burst server {mode}: no 'tiers=quant,exact' or no clean drain")
    finally:
        for _, out, proc in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    return rows


# ----------------------------------------------------------------- phase 23
# The two distilled students of the job (train/distill.py): the 8-member
# ensemble with train.distill_quant=true and the FT-Transformer, both with
# train.distill_bulk at its default (true), steps cut as in phase 19. The
# job's pos_weight 3 biases the teacher's probabilities, which a refit
# temperature cannot take out, so its quant student may fail the ECE gate
# (the JAX package's does on the same config); the same ensemble at the
# package default pos_weight 1 gives the quant tier that is then served.
STUDENT_RUNS = {
    "mlp-ens8": ["model.ensemble_size=8", "train.distill_quant=true"],
    "mlp-ens8-pw1": ["model.ensemble_size=8", "train.distill_quant=true",
                     "train.pos_weight=1.0"],
    "ft_transformer": ["model.family=ft_transformer"],
}
STUDENT_PROFILED_STEPS = 20


def _student_fit_launches(teacher, config, train_ds, device: str) -> dict:
    """Each student's fit in this process on the job's split: its wall
    (the distill functions' ``fit_s``, 800 steps) and, under
    ``torch.profiler`` over STUDENT_PROFILED_STEPS steps of the same
    loop, device ops and kernel-launch calls per step."""
    import dataclasses as dc

    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.ops.quant import init_quant_master, master_student_logits
    from mlops_tpu_torch.train import distill

    target = distill.teacher_logits(teacher, train_ds, device)
    cat, num = (torch.from_numpy(a).to(device) for a in (train_ds.cat_ids, train_ds.numeric))
    student_config = dc.replace(config.model, family="mlp", ensemble_size=1,
                                hidden_dims=(64, 64), dropout=0.0)
    student = init_params(build_model(student_config), 0).to(device)
    master = {k: v.to(device).requires_grad_() for k, v in init_quant_master(0).items()}
    fits = {
        "bulk": (student, list(student.parameters())),
        "quant": (lambda c, x: master_student_logits(master, c, x), list(master.values())),
    }
    out = {}
    for name, (forward, leaves) in fits.items():
        row = _route_profile(lambda: distill._fit(
            forward, leaves, target, cat, num, STUDENT_PROFILED_STEPS, 2048, 3e-3, 0), 1)
        out[name] = {k: row[k] / STUDENT_PROFILED_STEPS
                     for k in ("device_ops", "kernel_launch_calls")}
    return out


def phase_students(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """The students' main path: ``train --config
    configs/train_register_job.toml`` of each STUDENT_RUNS entry in three
    concurrent subprocesses (steps cut to EXACT_CUT_STEPS), each bundle's
    ``bulk`` block (and the ensembles' ``quant`` block) checked; each
    student's fit seconds and launches per step in this process; the
    gated quant tier served through ``quant_fused`` (phase 5's checks:
    ``serve serve.serve_tier=quant`` answering four bodies like the CPU
    route, a 64x1 and a 64x8 group in this process, the launches counted
    at replay); an ungated quant tier refused by the engine."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.train import distill

    root = WORK / "students"
    shutil.rmtree(root, ignore_errors=True)
    cut = [f"train.steps={EXACT_CUT_STEPS}", f"train.eval_every={EXACT_CUT_EVAL_EVERY}"]
    runs = {name: [*args, *cut, *extra] for name, args in STUDENT_RUNS.items()}
    started = {name: _start_train_cli(name, args, root, device) for name, args in runs.items()}
    clis, walls = {}, {}
    try:
        for name, run in started.items():
            clis[name], walls[name] = _finish_train_cli(name, runs[name], run, device)
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    bundles = {name: Path(out["bundle"]) for name, out in clis.items()}
    records = {}
    for name, path in bundles.items():
        manifest = json.loads((path / "manifest.json").read_text())
        bundle = load_bundle(path)
        check(bundle.has_bulk and (path / "bulk_params.msgpack").exists(),
              f"{name}: no bulk student in the bundle")
        fid = manifest["bulk"]["fidelity"]
        check(fid["mean_abs_prob_delta"] <= 0.05 and abs(fid["roc_auc_delta"]) <= 0.02,
              f"{name}: bulk student fidelity {fid}")
        records[name] = {"bulk": fid, "wall_s": walls[name],
                         "metrics": clis[name]["metrics"]}
        if "distill_quant=true" in " ".join(runs[name]):
            quant = manifest["quant"]
            check(bundle.has_quant and set(quant) == {"format", "fidelity", "temperature",
                                                      "gates"}, f"{name}: quant block {quant}")
            records[name]["quant"] = {k: quant[k] for k in ("fidelity", "temperature", "gates")}
        log(f"students {name}: {json.dumps(records[name])}")
    gated = [n for n in ("mlp-ens8", "mlp-ens8-pw1") if load_bundle(bundles[n]).quant_gates_passed]
    check(bool(gated), "no port-trained quant tier passed its gates: "
          f"{[records[n]['quant']['gates'] for n in ('mlp-ens8', 'mlp-ens8-pw1')]}")
    for name in ("mlp-ens8", "mlp-ens8-pw1"):
        if name not in gated:
            try:
                InferenceEngine(load_bundle(bundles[name]), serve_tier="quant", device=device)
            except ValueError as err:
                log(f"students {name}: quant tier refused as it should: {err}")
            else:
                raise SmokeFailure(f"{name}: an ungated quant tier was admitted")

    config = _job_config(["model.ensemble_size=8", *extra], device)
    train_ds, valid_ds = _exact_split(config)
    fit = {}
    teacher = load_bundle(bundles["mlp-ens8"]).model
    fit["bulk_fit_s"] = distill.distill_for_bulk(
        teacher, config.model, train_ds, valid_ds, device=device).fit_s
    fit["quant_fit_s"] = distill.distill_quant_student(
        teacher, train_ds, valid_ds, device=device).fit_s
    if device == "cuda":
        fit["per_step"] = _student_fit_launches(teacher, config, train_ds, device)
    log_timing("students fit (800 steps each, mlp-ens8 teacher)", fit)
    served = phase_serve(bundles[gated[0]], device)
    log(f"students: port-trained quant tier of {gated[0]} served, quant_fused launches "
        f"{served['launches']}")
    if device == "cuda":
        check(served["launches"] >= 1, "quant_fused never launched for the trained tier")
    return {"bundles": bundles, "records": records, "fit": fit, "quant_bundle": gated[0],
            "launches": served["launches"]}


# ----------------------------------------------------------------- phase 24
BULK_ROWS = 1_000_000
BULK_FT_ROWS = 262_144
BULK_CHUNK = 131_072  # ScoreConfig's default
BULK_REFERENCE_ROWS = 32_768  # of the first chunk, held against the CPU route


def _bulk_reference(bundle_dir: Path, ds, kw: dict, got, seed: int) -> dict:
    """The first chunk of a card sweep against the port's CPU route on the
    same rows (the exact tier's 1.6e-2 for a bf16 model, 1e-6 for the
    quant student's f32 forward; flags exact off the threshold band) and
    the dataset-level drift on the same sample (1e-5)."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.monitor.state import drift_scores
    from mlops_tpu_torch.parallel import bulk

    bundle = load_bundle(bundle_dir)
    scorer = bulk.make_chunk_scorer(bundle, device="cpu", **kw)
    rows = min(BULK_REFERENCE_ROWS, ds.n)
    cat = torch.from_numpy(ds.cat_ids[:rows].astype(np.int8))
    num = torch.from_numpy(ds.numeric[:rows])
    mask = torch.ones(rows, dtype=torch.bool)
    probs, flags = scorer.score(cat, num, mask)
    tol = PRED_ATOL if scorer.path == "quant" else EXACT_PRED_ATOL
    p_err = float(np.abs(probs.numpy() - got.predictions[:rows]).max())
    near = _near_threshold(bundle.monitor, num, mask).numpy()
    flag_diff = int(((flags.numpy() != got.outliers[:rows]) & ~near).sum())
    take = min(ds.n, 65_536)
    idx = np.random.default_rng(seed).choice(ds.n, take, replace=False)
    drift = drift_scores(bundle.monitor, torch.from_numpy(ds.cat_ids[idx]),
                         torch.from_numpy(ds.numeric[idx]), torch.ones(take, dtype=torch.bool))
    d_err = float(np.abs(drift.double().numpy() - np.asarray(
        list(got.feature_drift.values()))).max())
    check(p_err <= tol and flag_diff == 0 and d_err <= EXACT_DRIFT_ATOL,
          f"bulk {scorer.path}: first chunk against the CPU route: preds {p_err:.3g}, "
          f"flag mismatches {flag_diff}, drift {d_err:.3g}")
    return {"first_chunk_max_pred_err": p_err, "drift_max_err": d_err}


def phase_bulk(students: dict, device: str = "cuda", rows: int = BULK_ROWS,
               ft_rows: int = BULK_FT_ROWS, chunk: int = BULK_CHUNK) -> dict:
    """Bulk scoring, the main path: ``python -m mlops_tpu_torch
    score-batch data.rows=<rows>`` on phase 23's mlp-ens8 bundle in a
    subprocess (auto routing keeps the exact model on the card), then
    through the API at depth 2 and depth 1 (bitwise equal): the exact
    and distilled paths of that bundle, the quant path of the gated
    bundle at ``rows`` and the ft_transformer bundle at ``ft_rows``.
    For each: rows/s, the stage record, peak device memory, the first
    chunk against the CPU route, device ops and the device's busy share
    per chunk under ``torch.profiler`` over two chunks."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.parallel import bulk

    bundles = students["bundles"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "score-batch", f"data.rows={rows}",
         f"serve.model_directory={bundles['mlp-ens8']}", f"serve.device={device}",
         f"score.chunk_rows={chunk}"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600,
    )
    cli_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"score-batch exited {proc.returncode}: {proc.stderr[-3000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    check(cli["rows"] == rows and cli["devices"] == 1 and cli["mesh"] == [1]
          and cli["path"] == ("exact" if device == "cuda" else "distilled"),
          f"score-batch printed {json.dumps(cli)[:500]}")
    log_timing("bulk cli", {"wall_s": cli_wall, **{k: cli[k] for k in (
        "rows", "path", "elapsed_s", "rows_per_s", "default_rate", "outlier_rate")},
        "pipeline": cli["pipeline"]})

    columns, _ = generate_synthetic(rows, seed=0)
    ds = load_bundle(bundles["mlp-ens8"]).preprocessor.encode(columns)
    del columns
    cases = {
        "exact": (bundles["mlp-ens8"], dict(exact=True), ds),
        "distilled": (bundles["mlp-ens8"], dict(exact=False), ds),
        "quant": (bundles[students["quant_bundle"]], dict(tier="quant"), ds),
        "ft_transformer": (bundles["ft_transformer"], dict(exact=True), ds.slice(np.arange(ft_rows))),
    }
    out = {"cli": {**cli, "wall_s": cli_wall}}
    for name, (path, kw, data) in cases.items():
        bundle = load_bundle(path)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        two = bulk.score_dataset(bundle, data, chunk_rows=chunk, pipeline_depth=2,
                                 device=device, **kw)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        one = bulk.score_dataset(bundle, data, chunk_rows=chunk, pipeline_depth=1,
                                 device=device, **kw)
        check(np.array_equal(one.predictions.view(np.uint32), two.predictions.view(np.uint32))
              and np.array_equal(one.outliers, two.outliers)
              and one.feature_drift == two.feature_drift,
              f"bulk {name}: depth 1 and depth 2 differ")
        check(np.isfinite(two.predictions).all() and two.rows == data.n,
              f"bulk {name}: non-finite predictions or a row count of {two.rows}")
        row = {"path": two.path, "rows": two.rows, "rows_per_s": two.rows_per_s,
               "rows_per_s_depth1": one.rows_per_s, "elapsed_s": two.elapsed_s,
               "peak_device_bytes": peak, "pipeline": two.pipeline,
               **_bulk_reference(path, data, kw, two, seed=0)}
        if device == "cuda":
            scorer = bulk.make_chunk_scorer(bundle, device=device, **kw)
            transfer = bulk.make_chunk_transfer(device, chunk)
            fetch = bulk.ChunkFetch(torch.device(device), chunk)
            host = (data.cat_ids[:chunk].astype(np.int8), data.numeric[:chunk],
                    np.ones(chunk, bool))
            fetch([scorer(transfer(*host))])
            row["per_chunk"] = _route_profile(lambda: fetch([scorer(transfer(*host))]), 2)
        log_timing(f"bulk {name}", row)
        out[name] = row
        del bundle, one, two
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 25
STREAM_ROWS = 200_000


def phase_stream(students: dict, device: str = "cuda", rows: int = STREAM_ROWS,
                 chunk: int = BULK_CHUNK) -> dict:
    """Streamed bulk scoring: a ``rows``-row synthetic CSV (seed 7) through
    ``python -m mlops_tpu_torch score-batch score.streaming=true`` on
    phase 23's mlp-ens8 bundle in a subprocess; every output row equals
    the in-memory path's prediction rounded to 6 places, on the same
    device and chunk, and its outlier flag."""
    import csv

    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data import generate_synthetic, load_csv_columns, write_csv_columns
    from mlops_tpu_torch.parallel import bulk

    root = WORK / "stream"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    source, out_csv = root / "rows.csv", root / "scored.csv"
    columns, labels = generate_synthetic(rows, seed=7)
    write_csv_columns(source, columns, labels)
    bundle_dir = students["bundles"]["mlp-ens8"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "score-batch", "score.streaming=true",
         f"data.train_path={source}", f"score.output_path={out_csv}",
         f"serve.model_directory={bundle_dir}", f"serve.device={device}",
         f"score.chunk_rows={chunk}"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600,
    )
    cli_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"streamed score-batch exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    check(stats["rows"] == rows and not out_csv.with_name(out_csv.name + ".tmp").exists(),
          f"streamed score-batch printed {json.dumps(stats)[:500]}")
    bundle = load_bundle(bundle_dir)
    cols, _ = load_csv_columns(source)
    mem = bulk.score_dataset(bundle, bundle.preprocessor.encode(cols), chunk_rows=chunk,
                             device=device)
    check(mem.path == stats["path"], f"paths {mem.path} and {stats['path']}")
    with out_csv.open(newline="") as f:
        reader = csv.reader(f)
        check(next(reader) == ["prediction", "outlier"], "streamed output header")
        written = [(float(p), float(o)) for p, o in reader]
    want = list(zip(np.round(mem.predictions, 6).tolist(), mem.outliers.tolist()))
    mismatches = sum(a != b for a, b in zip(written, want))
    check(len(written) == rows and mismatches == 0,
          f"streamed output: {len(written)} rows, {mismatches} differ from the in-memory path")
    row = {"wall_s": cli_wall, **{k: stats[k] for k in (
        "rows", "path", "elapsed_s", "rows_per_s", "mean_prediction", "outlier_rate",
        "stages")}, "in_memory_rows_per_s": mem.rows_per_s}
    log_timing("stream", row)
    return row


# ----------------------------------------------------------------- phase 26
TUNE_JOB_TOML = "configs/train_register_job.toml"
TUNE_ARCH_TOML = "configs/tune_architectures.toml"
TUNE_ARCH_STEPS = 50  # phase 27: of the config's 1,000
TUNE_SMALL_T = 2  # the job's stack again at two trials: kernels per step
TUNE_KERNEL_GROWTH = 1.10  # kernels per step at T=10 within 10 % of T=2
TUNE_PARITY_TRIALS = 3
TUNE_PARITY_STEPS = 20
TUNE_KEYS = {"bundle", "model_uri", "best_trial", "best_hyperparams", "metrics", "trials"}
# The dense trainer's single-trial mlp step at the job's config (phase 20's
# median; H100 80GB HBM3, 700 W), printed beside the stacked step.
SINGLE_TRIAL_MLP_STEP = {"step_ms": 8.614, "kernels_per_step": 453.0, "busy_share": 0.207}


def _tune_cli(name: str, args: list[str], root: Path, bucket: Path | None = None,
              env: dict | None = None) -> tuple[dict, float, float]:
    """``python -m mlops_tpu_torch tune <args>`` in a subprocess (through
    ``gcs_main`` with ``bucket``, with ``env`` added to the environment):
    its JSON line (checked), its wall and the sweep's seconds from its
    log."""
    import re

    root.mkdir(parents=True, exist_ok=True)
    log_path = root / f"{name}.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.run(
            _cli(["tune", *args], bucket),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})),
            stdout=subprocess.PIPE, stderr=err, text=True, timeout=900,
        )
    wall = time.perf_counter() - t0
    text = log_path.read_text()
    check(proc.returncode == 0, f"tune {name} exited {proc.returncode}: {text[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(set(out) == TUNE_KEYS, f"tune {name} printed keys {sorted(out)}")
    check(all(math.isfinite(v) for v in out["metrics"].values()) and len(out["metrics"]) == 5,
          f"tune {name} metrics {out['metrics']}")
    swept = re.search(r"tune: (\d+) trials swept in ([0-9.]+) s", text)
    check(swept is not None and int(swept.group(1)) == out["trials"],
          f"tune {name}: no sweep line in its log")
    log(f"tune {name}: {wall:.1f} s (sweep {swept.group(2)} s): {json.dumps(out)}")
    return out, wall, float(swept.group(2))


def _check_tune_run(name: str, out: dict, run_dir: Path) -> list[dict]:
    """trials.jsonl (one record per trial, in order), best.json (the
    winner the CLI printed, the best finite objective) and the bundle."""
    trials = [json.loads(line) for line in (run_dir / "trials.jsonl").open()]
    check([t["trial"] for t in trials] == list(range(out["trials"])),
          f"tune {name}: trials.jsonl holds {len(trials)} records")
    best = json.loads((run_dir / "best.json").read_text())
    check(best["best_index"] == out["best_trial"] and best["metrics"] == out["metrics"]
          and best["hyperparams"] == out["best_hyperparams"],
          f"tune {name}: best.json {best} against the CLI's line")
    aucs = [t["metrics"]["validation_roc_auc_score"] for t in trials]
    # Random search: the best record wins. (Under SHA an eliminated
    # trial's record is as of its rung; the winner is a finalist.)
    check("rung" in trials[0] or out["metrics"]["validation_roc_auc_score"] == max(aucs),
          f"tune {name}: the winner is not the best AUC of {aucs}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    check(manifest["flavor"] == "flax" and manifest["calibration"]["temperature"] > 0
          and "quant" not in manifest,
          f"tune {name}: not a calibrated flax bundle without a quant tier")
    return trials


def _stack_timing(model_config, train_config, trials: int, data, horizon: int,
                  label: str) -> dict:
    """The stacked step of ``trials`` trials on the card: step ms over
    ``TIMED_WINDOWS`` windows of ``TIMED_STEPS`` (CUDA events, after 5
    warm-up steps; the median window, the fastest and slowest), the host
    clock around the same windows, device kernels and busy ms per step
    under ``torch.profiler`` (``PROFILED_STEPS``), peak device memory
    above what the process held before the stack (earlier phases' tensors
    stay allocated), and trial-rows trained per second (trials x batch /
    step)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlops_tpu_torch.config import HPOConfig
    from mlops_tpu_torch.train import hpo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    hp = hpo.sample_hyperparams(HPOConfig(trials=trials))
    stack = hpo.TrialStack(model_config, train_config, hp,
                           hpo.trial_seeds(2024, trials), horizon, data, torch.device("cuda"))
    for _ in range(5):
        stack.step()
    torch.cuda.synchronize()
    windows, walls = [], []
    for _ in range(TIMED_WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(TIMED_STEPS):
            stack.step()
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
        windows.append(start.elapsed_time(end) / TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() - held
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            stack.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in dev) / 1e3 / PROFILED_STEPS
    step_ms, wall_ms = float(np.median(windows)), float(np.median(walls))
    row = {
        "what": label, "family": model_config.family, "trials": trials,
        "batch": train_config.batch_size, "precision": model_config.precision,
        "params_per_trial": sum(stack.sizes),
        "step_ms": step_ms, "step_ms_min": min(windows), "step_ms_max": max(windows),
        "windows": TIMED_WINDOWS, "steps_per_window": TIMED_STEPS,
        "wall_ms_per_step_unprofiled": wall_ms,
        "trial_rows_per_s": trials * train_config.batch_size / step_ms * 1e3,
        "device_kernels_per_step": sum(e.count for e in dev) / PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "peak_device_bytes": peak,
    }
    log_timing("tune stacked step", row)
    row["kernel_counts"] = {e.key: e.count / PROFILED_STEPS for e in dev}
    del stack
    torch.cuda.empty_cache()
    return row


def _stack_parity(model_config, train_config, train_ds, valid_ds, device: str,
                  trials: int = TUNE_PARITY_TRIALS, steps: int = TUNE_PARITY_STEPS) -> dict:
    """The stacked trainer on the card against its CPU route: the same
    trials (init, rows and dropout masks are functions of the trial's
    key), one step's per-trial gradient cosine (>= 0.98), then
    ``steps`` steps' per-trial loss curves (within 0.05)."""
    import torch

    from mlops_tpu_torch.config import HPOConfig
    from mlops_tpu_torch.train import hpo

    hp = hpo.sample_hyperparams(HPOConfig(trials=trials))
    seeds = hpo.trial_seeds(2024, trials)
    stacks = {
        dev: hpo.TrialStack(model_config, train_config, hp, seeds, steps,
                            hpo.SweepData.put(train_ds, valid_ds, dev), torch.device(dev))
        for dev in (device, "cpu")
    }
    curves, grads = {}, {}
    for dev, stack in stacks.items():
        loss, grad = stack.loss_and_grad()
        grads[dev] = grad.float().cpu()
        stack.apply(grad)
        rest = [stack.run(steps - 1)] if steps > 1 else []
        curves[dev] = torch.cat([loss[None], *rest]).float().cpu()
    cos = torch.nn.functional.cosine_similarity(grads[device], grads["cpu"], dim=1)
    gap = (curves[device] - curves["cpu"]).abs()
    row = {
        "trials": trials, "steps": steps,
        "per_trial_grad_cosine": cos.tolist(),
        "per_trial_max_gap": gap.max(dim=0).values.tolist(),
        "first_loss": curves[device][0].tolist(), "last_loss": curves[device][-1].tolist(),
    }
    log(f"tune card vs cpu {json.dumps(row)}")
    check(all(torch.isfinite(c).all() for c in curves.values()), "non-finite sweep losses")
    check(float(cos.min()) >= GRAD_COSINE_MIN, f"stacked gradients part: cosine {cos.tolist()}")
    check(float(gap.max()) <= CURVE_MAX_GAP, f"stacked loss curves part: {gap.max(dim=0)}")
    return row


def phase_tune_job(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """The deployed training Job on local paths: ``python -m
    mlops_tpu_torch tune --config configs/train_register_job.toml`` in a
    subprocess at the job's full config (10 trials x 1,000 steps of the
    mlp, 50,000 rows, batch 1024, bf16), its records and bundle checked
    (phase 28 runs the same Job on a bucket, then promotes and serves its
    winner); then in this process, the counts set to 0 just before, the
    job's stacked step at 10 trials and at 2 (kernels per step within
    10 %), no kernel launched; and the stacked trainer on the card against
    its CPU route at 3 trials x 20 steps. ``extra`` and ``device="cpu"``
    rehearse the subprocess half small on the CPU."""
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.ops import quant_kernel

    root = WORK / "tune_job"
    shutil.rmtree(root, ignore_errors=True)
    reg = [f"registry.root={root / 'registry'}", f"registry.run_root={root / 'runs'}"]
    config = load_config([*extra, f"train.device={device}"], ROOT / TUNE_JOB_TOML)
    model, hcfg = config.model, config.hpo
    log(f"tune job: {TUNE_JOB_TOML} (rows {config.data.rows}, {hcfg.trials} trials x "
        f"{hcfg.steps} steps, strategy {hcfg.strategy}, batch {config.train.batch_size}, "
        f"{model.family} {model.hidden_dims} embed {model.embed_dim} {model.precision}, "
        f"dropout {model.dropout})")
    out, wall, sweep_s = _tune_cli(
        "job", ["--config", TUNE_JOB_TOML, *extra, *reg, "registry.run_name=job",
                f"train.device={device}"], root)
    check(out["trials"] == hcfg.trials, f"tune job swept {out['trials']} trials")
    trials = _check_tune_run("job", out, root / "runs" / "job")
    result = {
        "cli": {"wall_s": wall, "sweep_s": sweep_s, "trials": out["trials"],
                "steps": hcfg.steps, "best_trial": out["best_trial"],
                "best_hyperparams": out["best_hyperparams"], "metrics": out["metrics"],
                "aucs": [t["metrics"]["validation_roc_auc_score"] for t in trials]},
    }
    if device != "cuda":
        return result
    train_ds, valid_ds = _exact_split(config)
    from mlops_tpu_torch.train import hpo

    data = hpo.SweepData.put(train_ds, valid_ds, "cuda")
    _reset_launch_counts()
    quant_kernel.quant_kernel_launches.reset()
    rows = [_stack_timing(model, config.train, t, data, hcfg.steps, f"job T={t}")
            for t in (hcfg.trials, TUNE_SMALL_T)]
    launches = (*_launch_counts(), quant_kernel.quant_kernel_launches.value)
    check(launches == (0, 0, 0, 0), f"the stacked trainer launched kernels {launches}")
    growth = rows[0]["device_kernels_per_step"] / rows[1]["device_kernels_per_step"]
    big, small = (row.pop("kernel_counts") for row in rows)
    moved = {k: [small.get(k, 0.0), big.get(k, 0.0)] for k in set(big) | set(small)
             if big.get(k, 0.0) != small.get(k, 0.0)}
    log(f"tune job: kernels whose count per step differs, T={TUNE_SMALL_T} -> "
        f"T={hcfg.trials}: {json.dumps(moved)}")
    check(growth <= TUNE_KERNEL_GROWTH,
          f"kernels per step grew {growth:.3f}x from T={TUNE_SMALL_T} to T={hcfg.trials}")
    del data
    parity = _stack_parity(model, config.train, train_ds, valid_ds, device)
    result["kernels_differing_T2_T10"] = moved
    log_timing("tune job", {**result["cli"], "stacked_T10_over_T2_kernels": growth,
                            "single_trial_mlp_step": SINGLE_TRIAL_MLP_STEP})
    return {**result, "timing": rows, "kernel_growth_T10_over_T2": growth,
            "launches": launches, "card_vs_cpu": parity,
            "single_trial_mlp_step": SINGLE_TRIAL_MLP_STEP}


# ----------------------------------------------------------------- phase 27
def phase_tune_arch(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """The architecture sweep: ``tune --config configs/tune_architectures.toml
    hpo.strategy=sha`` in a subprocess at the config's widths (three
    groups of 8 trials: mlp 128x128 embed 8, mlp 256x256x128 embed 16,
    ft_transformer token_dim 64 depth 3), steps cut 1,000 -> 200; every
    record carries its group, architecture, rung and steps; the winner's
    bundle (a bulk student when an ensemble or a transformer wins); then
    the same command again under the same run name: no group trains
    (their records are not rewritten), the same best.json, a new version.
    Per group, the stacked step at 8 trials in this process."""
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train import hpo

    root = WORK / "tune_arch"
    shutil.rmtree(root, ignore_errors=True)
    args = ["hpo.strategy=sha", f"hpo.steps={TUNE_ARCH_STEPS}", *extra,
            f"registry.root={root / 'registry'}", f"registry.run_root={root / 'runs'}",
            "registry.run_name=arch"]
    config = load_config([*args, f"train.device={device}"], ROOT / TUNE_ARCH_TOML)
    hcfg = config.hpo
    counts, rung_steps, horizon = hpo.sha_plan(hcfg)
    log(f"tune arch: {TUNE_ARCH_TOML} hpo.strategy=sha, steps cut to {hcfg.steps} "
        f"(rungs {counts} of {rung_steps} steps, horizon {horizon}); groups "
        f"{list(hcfg.architectures)}, {hcfg.trials} trials each, rows {config.data.rows}")
    cli_args = ["--config", TUNE_ARCH_TOML, *args, f"train.device={device}"]
    out, wall, sweep_s = _tune_cli("arch", cli_args, root)
    run_dir = root / "runs" / "arch"
    trials = _check_tune_run("arch", out, run_dir)
    groups = len(hcfg.architectures)
    check(out["trials"] == groups * hcfg.trials, f"tune arch swept {out['trials']} trials")
    check(all({"group", "architecture", "rung", "steps"} <= set(t) for t in trials),
          "tune arch: a trial record lacks group/architecture/rung/steps")
    check(sum(t["steps"] == horizon for t in trials) == groups * counts[-1],
          f"tune arch: finalists {[t['steps'] for t in trials]}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    winner = manifest["model_config"]
    expensive = winner["ensemble_size"] > 1 or winner["family"] in ("ft_transformer", "bert")
    check(("bulk" in manifest) == expensive, f"tune arch: bulk block {manifest.get('bulk')}")
    group_files = sorted((run_dir / "hpo_groups").glob("group_*.json"))
    stamps = {p.name: p.stat().st_mtime_ns for p in group_files}
    best = (run_dir / "best.json").read_text()
    again, wall2, sweep2 = _tune_cli("arch_rerun", cli_args, root)
    check({p.name: p.stat().st_mtime_ns for p in group_files} == stamps
          and len(stamps) == groups, "the rerun retrained a group")
    check((run_dir / "best.json").read_text() == best, "the rerun wrote another best.json")
    check((again["best_trial"], again["metrics"]) == (out["best_trial"], out["metrics"])
          and int(again["model_uri"].rsplit("/", 1)[1]) == int(out["model_uri"].rsplit("/", 1)[1]) + 1,
          f"the rerun's result {again}")
    per_group = {}
    for g in range(groups):
        rows = [t for t in trials if t["group"] == g]
        per_group[g] = {
            "architecture": rows[0]["architecture"],
            "best_auc": max(t["metrics"]["validation_roc_auc_score"] for t in rows),
            "finalist_steps": max(t["steps"] for t in rows),
        }
    result = {
        "cli": {"wall_s": wall, "sweep_s": sweep_s, "rerun_wall_s": wall2,
                "rerun_sweep_s": sweep2, "trials": out["trials"], "plan": [counts, rung_steps, horizon],
                "best_trial": out["best_trial"], "best_hyperparams": out["best_hyperparams"],
                "metrics": out["metrics"]},
        "groups": per_group, "winner": winner["family"], "bulk": manifest.get("bulk"),
    }
    log_timing("tune arch", result["cli"])
    if device != "cuda":
        return result
    train_ds, valid_ds = _exact_split(config)
    data = hpo.SweepData.put(train_ds, valid_ds, "cuda")
    result["timing"] = [
        _stack_timing(hpo.parse_architecture_spec(spec, config.model), config.train,
                      hcfg.trials, data, horizon, f"arch group {g}")
        for g, spec in enumerate(hcfg.architectures)
    ]
    for row in result["timing"]:
        row.pop("kernel_counts")
    return result


# ----------------------------------------------------------------- phase 28
class FileBucket:
    """A fake GCS behind the storage client's transport ``(method, url,
    data, headers) -> (status, body)``, answering the JSON API calls
    ``utils/storage.py`` makes as ``tests/test_storage.py``'s ``FakeGCS``
    answers them: media upload, media and metadata GETs, prefix listing
    paged ``PAGE`` keys at a time, delimited listing, generations, and the
    metadata server's token; a call without a bearer token is refused.
    Objects are files under ``root/<bucket>/<key>``, each written by a
    rename, so every process given ``root`` shares one bucket; an
    object's generation is its file's mtime and inode. ``calls`` records
    each call's kind, key, bytes and seconds."""

    PAGE = 4

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.calls: list[tuple[str, str, int, float]] = []

    def transport(self, method: str, url: str, data: bytes | None,
                  headers: dict) -> tuple[int, bytes]:
        t0 = time.perf_counter()
        kind, key, status, body = self._answer(method, url, data, headers)
        self.calls.append((kind, key, len(data or b"") + len(body),
                           time.perf_counter() - t0))
        return status, body

    def _answer(self, method, url, data, headers):
        parsed = urllib.parse.urlparse(url)
        query = urllib.parse.parse_qs(parsed.query)
        path = urllib.parse.unquote(parsed.path)
        if parsed.hostname == "metadata.google.internal":
            return "token", "", 200, json.dumps({"access_token": "fake-token"}).encode()
        if not headers.get("Authorization", "").startswith("Bearer "):
            return "refused", path, 401, b"{}"
        if method == "POST" and path.startswith("/upload/storage/v1/b/"):
            bucket, key = path.split("/")[5], query["name"][0]
            target = self.root / bucket / key
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.root / ".tmp" / f"{os.getpid()}-{threading.get_ident()}"
            tmp.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_bytes(data)
            os.replace(tmp, target)
            return "upload", key, 200, b"{}"
        parts = path.split("/", 6)  # ['', 'storage', 'v1', 'b', bucket, 'o', key]
        if method != "GET" or parts[1:4] != ["storage", "v1", "b"]:
            return "unknown", path, 400, b"{}"
        bucket = parts[4]
        if len(parts) < 7:
            return "list", query.get("prefix", [""])[0], 200, self._list(bucket, query)
        key = parts[6]
        target = self.root / bucket / key
        if not target.is_file():
            return "missing", key, 404, b"{}"
        if query.get("alt") == ["media"]:
            return "media", key, 200, target.read_bytes()
        st = target.stat()
        # Every write is a new file by rename: a new inode, even where two
        # writes share an mtime tick.
        meta = {"name": key, "size": str(st.st_size),
                "generation": f"{st.st_mtime_ns}{st.st_ino:020d}"}
        return "stat", key, 200, json.dumps(meta).encode()

    def _list(self, bucket: str, query: dict) -> bytes:
        prefix = query.get("prefix", [""])[0]
        base = self.root / bucket
        start = base / prefix.rpartition("/")[0]
        names = sorted(
            name for name in (p.relative_to(base).as_posix()
                              for p in start.rglob("*") if p.is_file())
            if name.startswith(prefix)
        ) if start.is_dir() else []
        delimiter = query.get("delimiter", [None])[0]
        if delimiter:
            prefixes, leaves = set(), []
            for name in names:
                rest = name[len(prefix):]
                if delimiter in rest:
                    prefixes.add(prefix + rest.split(delimiter, 1)[0] + delimiter)
                else:
                    leaves.append(name)
            return json.dumps({"items": [{"name": n} for n in leaves],
                               "prefixes": sorted(prefixes)}).encode()
        page = int(query.get("pageToken", ["0"])[0] or 0)
        payload = {"items": [{"name": n} for n in names[page:page + self.PAGE]]}
        if page + self.PAGE < len(names):
            payload["nextPageToken"] = str(page + self.PAGE)
        return json.dumps(payload).encode()

    def holdings(self) -> dict:
        """The objects and bytes each bucket under ``root`` holds."""
        out = {}
        for bucket in sorted(p for p in self.root.iterdir() if p.name != ".tmp"):
            files = [p for p in bucket.rglob("*") if p.is_file()]
            out[bucket.name] = {"objects": len(files),
                                "bytes": sum(p.stat().st_size for p in files)}
        return out


def gcs_main(bucket_root: str, argv: list[str]) -> int:
    """``mlops_tpu_torch.cli.main(argv)`` with the port's process-wide GCS
    client speaking to the ``FileBucket`` at ``bucket_root`` (the card
    machine has no network): every ``gs://`` path of the command reads and
    writes there, token from the fake metadata server. The seconds spent
    staging data (``read_to_file``, the local copy included) and uploading
    and downloading bundles (``upload_dir`` / ``download_dir``), with the
    bucket's call record, go to ``<bucket_root>.calls/<pid>.json`` as the
    command returns."""
    sys.path.insert(0, str(ROOT))
    from mlops_tpu_torch import cli
    from mlops_tpu_torch.utils import storage

    os.environ.pop("GCS_ACCESS_TOKEN", None)
    bucket = FileBucket(bucket_root)
    client = storage.GCSClient(transport=bucket.transport)
    storage._default_client = client
    spent: dict[str, float] = {}

    def timed(what, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[what] = spent.get(what, 0.0) + time.perf_counter() - t0
        return run

    client.read_to_file = timed("data_staging", client.read_to_file)
    storage.upload_dir = timed("bundle_upload", storage.upload_dir)
    storage.download_dir = timed("bundle_download", storage.download_dir)
    try:
        return cli.main(argv)
    finally:
        record = Path(f"{bucket_root}.calls") / f"{os.getpid()}.json"
        record.parent.mkdir(parents=True, exist_ok=True)
        record.write_text(json.dumps({"command": argv[0], "calls": bucket.calls,
                                      "spent_s": spent}))


def _bucket_seconds(bucket_root: Path) -> dict:
    """Per command: the seconds ``gcs_main`` timed (``spent_s``), and the
    calls, bytes and seconds the fake bucket served by what they moved:
    ``data`` (the dataset: metadata and media), ``bundle`` (objects under
    ``versions/``: uploads, listings and downloads), ``index``
    (``index.json``) and ``token``."""
    out: dict = {}
    for path in sorted(Path(f"{bucket_root}.calls").glob("*.json")):
        rec = json.loads(path.read_text())
        row = out.setdefault(rec["command"], {"spent_s": {}, "bucket": {}})
        for what, seconds in rec["spent_s"].items():
            row["spent_s"][what] = row["spent_s"].get(what, 0.0) + seconds
        for kind, key, nbytes, seconds in rec["calls"]:
            what = ("token" if kind == "token" else "bundle" if "/versions/" in key
                    else "index" if key.endswith("index.json") else "data")
            cell = row["bucket"].setdefault(what, {"calls": 0, "bytes": 0, "s": 0.0})
            cell["calls"] += 1
            cell["bytes"] += nbytes
            cell["s"] += seconds
    return out


def _start(cmd: list[str], env: dict, log: Path) -> tuple[subprocess.Popen, Path]:
    """``cmd`` started with ``env`` added, its stdout and stderr going to
    ``<log>.out`` and ``<log>.err`` (files: a pipe nobody reads while the
    caller waits on something else could fill and stall it)."""
    with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                                env=dict(os.environ, PYTHONPATH=str(ROOT), **env))
    return proc, log


def _finish(procs: dict, timeout: int = 600) -> dict:
    """Wait for ``_start``'s subprocesses: name -> (exit code, stdout,
    stderr); any still running past ``timeout`` is killed."""
    out = {}
    try:
        for name, (proc, log) in procs.items():
            proc.wait(timeout=timeout)
            out[name] = (proc.returncode, Path(f"{log}.out").read_text(),
                         Path(f"{log}.err").read_text())
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return out


JOB_NAME = "train-job"  # registry.run_name, as the manifest's ${JOB_NAME}
TB_STEPS = 50  # the TensorBoard run: of the job's 2,000
TB_EVAL_EVERY = 25


def phase_deployed_job(local: dict | None = None, extra: tuple[str, ...] = (),
                       device: str = "cuda") -> dict:
    """The deployed Job as ``kubernetes/train-job.yml`` runs it, against a
    fake bucket (``FileBucket``; every command runs through ``gcs_main``):
    the job config's ``data.rows`` synthetic rows written as a CSV and
    uploaded as ``gs://<bucket>/curated.csv``; then exactly the manifest's
    argv, ``tune --config configs/train_register_job.toml
    data.train_path=gs://... registry.root=gs://... registry.run_name=...``
    (the run root through ``MLOPS_TPU_REGISTRY_RUN_ROOT``, as a pod's
    environment would give it); ``promote`` of the winner to production on
    the bucket; ``serve serve.model_directory=production
    registry.root=gs://...`` with ``MLOPS_TPU_SERVE_WORKERS=0`` and the
    port through ``MLOPS_TPU_SERVE_PORT``, as the serving image sets them,
    answering the golden request and 5/64/256-record bodies like the CPU
    route on the bundle the registry resolves, and at once the same
    ``serve`` as the serving image starts it, ``MLOPS_TPU_SERVE_WORKERS=2``
    (the ring plane) with ``MLOPS_TPU_CACHE_DIR`` set, answering the same;
    the same ``serve`` with ``MLOPS_TPU_SERVE_LOOP_LAG_SLOW_MS=0`` exits
    non-zero with the JAX package's validation message; a ``train`` of the
    job config with
    the steps cut to 50 and ``train.tensorboard_dir`` set writes event
    files (or, where ``torch.utils.tensorboard`` cannot be built, warns as
    the JAX package does); where pyarrow imports, ``score-batch`` on the
    same rows as ``gs://.../rows.parquet`` equals the CSV's to 6 places.
    ``local`` is phase 26's CLI record, printed beside. ``extra`` and
    ``device="cpu"`` (given through ``MLOPS_TPU_*_DEVICE``) rehearse it
    small on the CPU."""
    import numpy as np

    from mlops_tpu_torch.bundle.registry import ModelRegistry
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
    from mlops_tpu_torch.utils import storage

    root = WORK / "deployed_job"
    shutil.rmtree(root, ignore_errors=True)
    bucket_root = root / "bucket"
    bucket_root.mkdir(parents=True)
    gs = "gs://smoke-bucket"
    registry_root = f"{gs}/registry"
    # The pod's environment: its own HOME (the data and registry caches
    # live under it) and run root, and the device only when rehearsing.
    env = {"HOME": str(root / "home"), "MLOPS_TPU_REGISTRY_RUN_ROOT": str(root / "runs")}
    if device != "cuda":
        env.update(MLOPS_TPU_TRAIN_DEVICE=device, MLOPS_TPU_SERVE_DEVICE=device)
    config = load_config(list(extra), ROOT / TUNE_JOB_TOML, env={})
    columns, labels = generate_synthetic(config.data.rows, seed=config.data.seed)
    write_csv_columns(root / "curated.csv", columns, labels)
    client = storage.GCSClient(transport=FileBucket(bucket_root).transport)
    client.write_bytes(f"{gs}/curated.csv", (root / "curated.csv").read_bytes())

    job_args = ["--config", TUNE_JOB_TOML, f"data.train_path={gs}/curated.csv",
                f"registry.root={registry_root}", f"registry.run_name={JOB_NAME}", *extra]
    log(f"deployed job: tune {' '.join(job_args)}")
    out, wall, sweep_s = _tune_cli("deployed", job_args, root, bucket=bucket_root, env=env)
    check(out["trials"] == config.hpo.trials, f"the deployed job swept {out['trials']} trials")
    check(out["model_uri"].startswith(f"models:/{config.registry.model_name}/"),
          f"the deployed job registered {out['model_uri']}")
    trials = _check_tune_run("deployed", out, root / "runs" / JOB_NAME)
    version = out["model_uri"].rsplit("/", 1)[1]

    (code, stdout, stderr), = _finish({"promote": _start(_cli(
        ["promote", f"registry.root={registry_root}", f"registry.promote_version={version}",
         "registry.promote_stage=production"], bucket_root), env, root / "promote")}).values()
    check(code == 0 and json.loads(stdout) == {
        "model": config.registry.model_name, "version": int(version), "stage": "production"},
        f"promote: {stdout} {stderr[-2000:]}")
    registry = ModelRegistry(registry_root, client=client, cache_dir=root / "resolved")
    staged = registry.resolve(config.registry.model_name, "production")
    for name in ("manifest.json", "params.msgpack"):
        check((staged / name).read_bytes() == (Path(out["bundle"]) / name).read_bytes(),
              f"the production stage on the bucket does not hold the tuned {name}")

    serve_args = ["serve", "serve.model_directory=production", f"registry.root={registry_root}"]

    def launch(path, port, dev):
        return _cli(serve_args, bucket_root), {
            **env, "MLOPS_TPU_SERVE_WORKERS": "0", "MLOPS_TPU_SERVE_PORT": str(port),
            "MLOPS_TPU_SERVE_HOST": "127.0.0.1"}

    # The rest runs while the production stage serves (on the
    # single-process server and, as the serving image starts it, on the
    # two-worker ring plane with the kernel cache): the refusal of an
    # invalid serve key, the TensorBoard run and, where pyarrow imports,
    # score-batch on the Parquet twin and the CSV (their resolves of
    # production race the servers' downloads into the one registry cache:
    # a rename decides).
    refused = {"MLOPS_TPU_SERVE_LOOP_LAG_SLOW_MS": ("0", "serve.loop_lag_slow_ms=0.0 must be > 0")}
    procs = {key: _start(_cli(serve_args, bucket_root), {**env, key: value}, root / key)
             for key, (value, _) in refused.items()}
    tb_dir = root / "tensorboard"
    procs["tensorboard"] = _start(_cli(
        ["train", "--config", TUNE_JOB_TOML, *extra, f"train.steps={TB_STEPS}",
         f"train.eval_every={TB_EVAL_EVERY}", f"train.tensorboard_dir={tb_dir}",
         f"registry.root={root / 'tb_registry'}", "registry.run_name=tensorboard"]), env,
        root / "tensorboard")
    pyarrow = _pyarrow_version()
    if pyarrow:
        from mlops_tpu_torch.data.parquet import write_parquet_columns

        write_parquet_columns(root / "rows.parquet", columns, labels)
        client.write_bytes(f"{gs}/rows.parquet", (root / "rows.parquet").read_bytes())
        for name in ("curated.csv", "rows.parquet"):
            procs[name] = _start(_cli(
                ["score-batch", "serve.model_directory=production",
                 f"registry.root={registry_root}", f"data.train_path={gs}/{name}",
                 f"score.output_path={root / f'scored-{name}.npz'}"], bucket_root), env,
                root / f"score-{name}")
    try:
        bodies = tuple(_records(n, seed=60 + n, drift=0.2) for n in (5, 64, 256))
        http = _serve_golden(
            {"production": staged, "production_ring": staged}, device, launch=launch,
            bodies=bodies, env_by_name={"production_ring": {
                "MLOPS_TPU_SERVE_WORKERS": "2",
                "MLOPS_TPU_CACHE_DIR": str(root / "cache")}})
    finally:
        done = _finish(procs)

    refusals = {}
    for key, (value, message) in refused.items():
        code, _, stderr = done[key]
        check(code != 0 and message in stderr,
              f"serve with {key}={value} exited {code}: {stderr[-2000:]}")
        refusals[key] = stderr.strip().splitlines()[-1]
        log(f"deployed job: {key}={value} refused: {refusals[key]}")

    code, _, stderr = done["tensorboard"]
    check(code == 0, f"train with train.tensorboard_dir: {stderr[-3000:]}")
    events = sorted(p.name for p in tb_dir.glob("events.out.tfevents.*"))
    warned = [line for line in stderr.splitlines() if "tensorboard writer unavailable" in line]
    check(bool(events) != bool(warned), f"tensorboard: events {events}, warnings {warned}")
    tensorboard = {"event_files": events, "warning": warned[0] if warned else None}
    log(f"deployed job: tensorboard {json.dumps(tensorboard)}")

    parquet = {"pyarrow": "absent"}
    if pyarrow:
        scored = {}
        for name in ("curated.csv", "rows.parquet"):
            code, stdout, stderr = done[name]
            check(code == 0, f"score-batch {name}: {stderr[-3000:]}")
            scored[name] = (json.loads(stdout.strip().splitlines()[-1]),
                            np.load(root / f"scored-{name}.npz")["predictions"])
        (_, csv_p), (pq_out, pq_p) = scored.values()
        gap = float(np.abs(csv_p - pq_p).max())
        check(csv_p.shape == pq_p.shape == (len(labels),)
              and np.array_equal(np.round(csv_p, 6), np.round(pq_p, 6)),
              f"score-batch on Parquet differs from the CSV by {gap}")
        parquet = {"pyarrow": pyarrow, "rows": int(pq_p.size), "max_gap": gap,
                   "path": pq_out["path"]}
    log(f"deployed job: parquet {json.dumps(parquet)}")

    holdings = FileBucket(bucket_root).holdings()
    moved = _bucket_seconds(bucket_root)
    result = {
        "cli": {"wall_s": wall, "sweep_s": sweep_s, "trials": out["trials"],
                "best_trial": out["best_trial"], "best_hyperparams": out["best_hyperparams"],
                "metrics": out["metrics"],
                "aucs": [t["metrics"]["validation_roc_auc_score"] for t in trials]},
        "local_cli": {k: local[k] for k in ("wall_s", "sweep_s", "best_trial", "metrics")}
        if local else None,
        "staging_s": {
            "data": moved["tune"]["spent_s"]["data_staging"],
            "bundle_upload": moved["tune"]["spent_s"]["bundle_upload"],
            # The server or a score-batch, whichever resolved first; a
            # loser of the rename downloaded too.
            "bundle_download": [row["spent_s"]["bundle_download"] for row in moved.values()
                                if "bundle_download" in row["spent_s"]],
        },
        "bucket_calls": moved, "bucket_holdings": holdings,
        "promoted_version": int(version),
        "requests_answered": 1 + len(bodies), "max_pred_gap_to_cpu": http["production"],
        "ring_max_pred_gap_to_cpu": http["production_ring"],
        "refusals": refusals, "tensorboard": tensorboard, "parquet": parquet,
    }
    log_timing("deployed job", {k: result[k] for k in (
        "cli", "local_cli", "staging_s", "bucket_holdings", "requests_answered",
        "max_pred_gap_to_cpu", "ring_max_pred_gap_to_cpu")})
    return result


# ----------------------------------------------------------------- phase 29
# The serving image's start (docker/Dockerfile:38-55,
# kubernetes/manifest.yml:53-60): two SO_REUSEPORT front ends over the
# shared-memory ring to one engine process, the kernel cache baked by
# `warmup --cache-dir` and named by MLOPS_TPU_CACHE_DIR.
RING_WORKERS = 2
RING_KILL_REQUESTS = 300  # single-record requests streamed across an engine kill (cut from 600)
RING_KILL_CONCURRENCY = 16
RING_BITWISE_REQUESTS = 64  # re-sent to the respawned engine, one at a time
RING_DRAIN_REQUESTS = 400  # streamed while the plane drains on SIGTERM
RING_C1_REQUESTS = 250  # of a burst's requests, sent at one connection


def _image_env(bundle_dir: Path, cache: Path, port: int, workers: int, device: str) -> dict:
    """The serving image's environment for ``serve`` (the model and
    service name, the workers, the cache), the burst's tier routing, and
    the port."""
    env = {"MODEL_DIRECTORY": str(bundle_dir), "SERVICE_NAME": "credit-default-api",
           "MLOPS_TPU_SERVE_WORKERS": str(workers), "MLOPS_TPU_CACHE_DIR": str(cache),
           "MLOPS_TPU_SERVE_TIER_ROUTING": "true", "MLOPS_TPU_SERVE_PORT": str(port),
           "MLOPS_TPU_SERVE_HOST": "127.0.0.1"}
    if device != "cuda":
        env["MLOPS_TPU_SERVE_DEVICE"] = device
    return env


def _wait_ready(port: int, proc, what: str, timeout: float = 600) -> None:
    deadline = time.monotonic() + timeout
    while True:
        check(proc.poll() is None, f"{what} exited early ({proc.returncode})")
        try:
            if _http(port, "GET", "/healthz/ready")[0] == 200:
                return
        except OSError:
            pass
        check(time.monotonic() < deadline, f"{what} never became ready")
        time.sleep(0.05)


def _ring_log(path: Path) -> tuple[dict, list[dict], str]:
    """The plane's log: the latest pid of each process (``engine`` is
    replica 0's, ``engine r`` replica r's), every engine ready record, and
    the text."""
    text = path.read_text(errors="replace")
    pids, ready = {}, []
    for line in text.splitlines():
        if line.startswith("engine replica ") and " started (pid " in line:
            pid, replica = int(line.split("pid ")[1].rstrip(")")), int(line.split()[2])
            pids[f"engine {replica}"] = pid
            if replica == 0:
                pids["engine"] = pid
        elif line.startswith("frontend ") and " started (pid " in line:
            pids[f"frontend {line.split()[1]}"] = int(line.split("pid ")[1].rstrip(")"))
        elif line.startswith("warmup complete; ready {"):
            ready.append(json.loads(line.split("ready ", 1)[1]))
    return pids, ready, text


def _children(pid: int) -> list[int]:
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = Path(f"/proc/{entry}/stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def _holds_card(pid: int) -> bool:
    """The process has the card's device files open (a CUDA context)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def _cpu_s(pid: int) -> float:
    """User plus system CPU seconds of ``pid`` so far (/proc; 0 when gone)."""
    try:
        fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    except OSError:
        return 0.0
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _compute_apps() -> list[int] | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _sub_burst(burst: dict, idx: list[int]) -> dict:
    sub = {**burst, **{k: [burst[k][i] for i in idx]
                       for k in ("bodies", "headers", "want", "off_band", "tol")}}
    sub["rows"] = sum(len(json.loads(body)) for body in sub["bodies"])
    return sub


def _tolerant_burst(port: int, burst: dict, concurrency: int) -> list:
    """``_run_burst``, except that a connection the server closes (a
    drain) ends that client instead of failing: unanswered requests stay
    None."""
    import asyncio

    n = len(burst["bodies"])
    out, lat = [None] * n, [0.0] * n
    order = iter(range(n))

    async def client():
        try:
            await _burst_client(port, burst, order, out, lat)
        except (OSError, IndexError, ValueError, asyncio.IncompleteReadError):
            pass

    async def main():
        await asyncio.gather(*(client() for _ in range(concurrency)))

    asyncio.run(main())
    return out


def _scrape_ring(port: int) -> dict:
    _, text = _http(port, "GET", "/metrics")
    text = text.decode()
    return {name: _metric(text, f"mlops_tpu_{name}") for name in (
        "engine_incarnation", "engine_respawn_total", "replayed_slots_total",
        "monitor_rows_lost_total", "brownout_shed_total", "parked_requests",
        "rows_scored_total")}


def _await_rows(port: int, before: dict, rows: int, what: str) -> dict:
    """The scrape once the monitor aggregate counts ``rows`` more rows
    (the ring plane's engine writes it on its telemetry cadence)."""
    deadline = time.monotonic() + 15
    while True:
        after = _scrape(port)
        if after["rows"] - before["rows"] >= rows or time.monotonic() > deadline:
            check(after["rows"] - before["rows"] == rows,
                  f"{what}: /metrics rows {after['rows'] - before['rows']} != records sent {rows}")
            return after
        time.sleep(0.1)


def _kill_engine(port: int, log_path: Path, burst: dict, cpu_stream: bool) -> dict:
    """kill -9 the engine; with ``cpu_stream``, while RING_KILL_CONCURRENCY
    connections stream RING_KILL_REQUESTS single-record requests, each
    answer then held against the CPU route. Times kill -> ready (the
    incarnation bumped and /healthz/ready 200)."""
    pids, ready, _ = _ring_log(log_path)
    before = _scrape_ring(port)
    sub = _sub_burst(burst, list(range(RING_KILL_REQUESTS)))
    result = {}
    thread = None
    if cpu_stream:
        thread = threading.Thread(target=lambda: result.setdefault(
            "out", _tolerant_burst(port, sub, RING_KILL_CONCURRENCY)))
        thread.start()
        time.sleep(0.2)
    os.kill(pids["engine"], signal.SIGKILL)
    t_kill = time.monotonic()
    while True:
        try:
            m = _scrape_ring(port)
            if (m["engine_incarnation"] > before["engine_incarnation"]
                    and _http(port, "GET", "/healthz/ready")[0] == 200):
                break
        except OSError:
            pass
        check(time.monotonic() - t_kill < 300, "the engine never came back after kill -9")
        time.sleep(0.02)
    kill_to_ready = time.monotonic() - t_kill
    if thread is not None:
        thread.join(timeout=300)
        _check_burst(sub, result["out"], "ring kill -9 stream")
    after = _scrape_ring(port)
    _, ready_after, _ = _ring_log(log_path)
    check(len(ready_after) == len(ready) + 1, "no ready record from the respawned engine")
    new = ready_after[-1]
    check(after["engine_respawn_total"] == before["engine_respawn_total"] + 1,
          "the respawn was not counted")
    return {"kill_to_ready_s": kill_to_ready, "engine_ready_s": new["ready_s"],
            "nvcc_calls": new["nvcc_calls"], "incarnation": new["incarnation"],
            "replayed_slots": after["replayed_slots_total"] - before["replayed_slots_total"],
            "monitor_rows_lost": after["monitor_rows_lost_total"]
            - before["monitor_rows_lost_total"],
            "stream_requests": RING_KILL_REQUESTS if cpu_stream else 0}


_RING_BURSTS: dict = {}


def _ring_bursts(bundle_dir: Path) -> list[dict]:
    """Phase 29's bursts on ``bundle_dir`` (2 x BURST_REQUESTS requests and
    the CPU route's answers), built once and kept for phase 33."""
    key = (str(bundle_dir), BURST_REQUESTS)
    if key not in _RING_BURSTS:
        from mlops_tpu_torch.bundle import load_bundle
        from mlops_tpu_torch.serve.engine import InferenceEngine

        bundle = load_bundle(bundle_dir)
        cpu = InferenceEngine(bundle, device="cpu", tier_routing=True)
        _RING_BURSTS[key] = [_burst_set(bundle, cpu, kind, seed)
                             for kind, seed in (("single", 41), ("mixed", 42))]
    return _RING_BURSTS[key]


def phase_ring(bundle_dir: Path, device: str = "cuda") -> dict:
    """The serving image's start on the ring plane: ``warmup --cache-dir``
    into an empty cache (cold, then reused), then ``serve`` with the
    image's environment (``MODEL_DIRECTORY``, ``SERVICE_NAME``,
    ``MLOPS_TPU_SERVE_WORKERS=2``, ``MLOPS_TPU_CACHE_DIR``) plus tier
    routing, beside the same with ``MLOPS_TPU_SERVE_WORKERS=0`` (the
    single-process server). The engine process builds no kernel and is the
    plane's only process holding the card (``/proc`` fds, and
    ``nvidia-smi --query-compute-apps`` where it lists this machine's
    processes). Phase 22's bursts go to both planes in turns: every answer
    held against the CPU route, /metrics rows equal to the records sent,
    no demotion, quant_fused launches equal to the quant-tier dispatches;
    requests/s, p50/p99 and dispatches per request. Then on the ring
    plane: kill -9 of the engine while 16 connections stream requests
    (every answer 200 and right, the respawned engine ready without nvcc;
    kill -> ready timed), its answers bitwise equal to the dead engine's;
    kill -9 again with the cache emptied (kill -> ready with an nvcc
    build); kill -9 of a front end (respawn timed); SIGTERM while traffic
    flows: every answer 200, every process exits 0."""
    import numpy as np

    root = WORK / "ring"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache = root / "cache"
    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    warm = {}
    if device == "cuda":  # warmup needs nvcc, which only the card machine has
        for kind in ("cold", "reused"):
            env = _image_env(bundle_dir, cache, 0, RING_WORKERS, device)
            t0 = time.perf_counter()
            proc = subprocess.run(_cli(["warmup", "--cache-dir", str(cache)]), cwd=ROOT,
                                  env={**base_env, **env}, capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"warmup {kind}: {proc.stderr[-3000:]}")
            report = json.loads(proc.stdout.strip().splitlines()[-1])
            names = [row["name"] for row in report["libraries"]]
            check(names == ["quant_fused"], f"warmup {kind} built {names}")
            check(report["built" if kind == "cold" else "reused"] == 1
                  and report["nvcc_calls"] == (kind == "cold"),
                  f"warmup {kind}: {report}")
            warm[kind] = {"wall_s": wall, **report}
            log_timing(f"ring warmup {kind}", warm[kind])
    bursts = _ring_bursts(bundle_dir)
    planes = {}
    for mode, workers in (("ring", RING_WORKERS), ("single", 0)):
        port = _free_port()
        log_path = WORK / f"ring_server_{mode}.log"
        out = open(log_path, "wb")
        planes[mode] = (port, out, subprocess.Popen(
            _cli(["serve"]), cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            env={**base_env, **_image_env(bundle_dir, cache, port, workers, device)}),
            log_path)
    rows, kills = [], {}
    try:
        for mode, (port, _, proc, _) in planes.items():
            _wait_ready(port, proc, f"{mode} plane")
        port, _, proc, log_path = planes["ring"]
        pids, ready, text = _ring_log(log_path)
        check(len(ready) == 1 and (device != "cuda" or ready[0]["nvcc_calls"] == 0),
              f"the ring engine's start: {ready}")
        check("tiers=quant,exact" in text, "the ring engine does not hold both tiers")
        plane = {proc.pid, *_children(proc.pid)}
        check(set(pids.values()) <= plane, f"plane pids {pids} vs {plane}")
        holders = sorted(pid for pid in plane if _holds_card(pid))
        apps = _compute_apps()
        if device == "cuda":
            check(holders == [pids["engine"]],
                  f"processes holding the card {holders}, engine {pids['engine']}")
            if apps and os.getpid() in apps:
                check(sorted(plane & set(apps)) == [pids["engine"]],
                      f"nvidia-smi lists {sorted(plane & set(apps))} of the plane")
        cuda_check = {"plane_pids": sorted(plane), "engine_pid": pids["engine"],
                      "holding_the_card": holders, "nvidia_smi_compute_apps": apps,
                      "engine_ready_s": ready[0]["ready_s"], "nvcc_calls": ready[0]["nvcc_calls"]}
        log(f"ring plane: {json.dumps(cuda_check)}")
        c1_single = None
        # Whose CPU a burst takes: each front end, the engine, the
        # single-process server and this process (the load generator).
        procs = {"client": os.getpid(), "single": planes["single"][2].pid,
                 **{name: pid for name, pid in pids.items()}}
        for burst in bursts:
            for concurrency in BURST_CONCURRENCY:
                for mode, (port, _, _, _) in planes.items():
                    sent = (burst if concurrency > 1
                            else _sub_burst(burst, list(range(RING_C1_REQUESTS))))
                    before = _scrape(port)
                    cpu0 = {name: _cpu_s(pid) for name, pid in procs.items()}
                    out, lat, wall = _run_burst(port, sent, concurrency)
                    cpu = {name: round((_cpu_s(pid) - cpu0[name]) / wall, 3)
                           for name, pid in procs.items()}
                    what = f"ring phase {burst['kind']} c={concurrency} {mode}"
                    worst = _check_burst(sent, out, what)
                    after = _await_rows(port, before, sent["rows"], what)
                    d = {k: after[k] - before[k] for k in before}
                    check(d["demotions"] == 0, f"{what}: {d['demotions']} demotions")
                    expected = d["quant_dispatches"] if device == "cuda" else 0
                    check(d["launches"] == expected,
                          f"{what}: {d['launches']} quant_fused launches for "
                          f"{d['quant_dispatches']} quant-tier dispatches")
                    if mode == "ring" and burst["kind"] == "single" and concurrency == 1:
                        c1_single = out
                    row = {
                        "kind": burst["kind"], "concurrency": concurrency, "plane": mode,
                        "workers": RING_WORKERS if mode == "ring" else 0,
                        "requests": len(sent["bodies"]), "records": sent["rows"],
                        "requests_per_s": len(sent["bodies"]) / wall,
                        "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "dispatches_per_request": d["dispatches"] / len(sent["bodies"]),
                        "grouped_dispatches_per_request":
                            d["group_dispatches"] / len(sent["bodies"]),
                        "quant_dispatches": d["quant_dispatches"],
                        "quant_fused_launches": d["launches"],
                        "max_pred_err": worst["pred"], "max_drift_err": worst["drift"],
                        "cpu_share": cpu,
                    }
                    log_timing("ring burst", row)
                    rows.append(row)
        port, _, proc, log_path = planes["ring"]
        single = bursts[0]
        kills["cache_filled"] = _kill_engine(port, log_path, single, cpu_stream=True)
        if device == "cuda":
            check(kills["cache_filled"]["nvcc_calls"] == 0,
                  f"the respawned engine built a kernel: {kills['cache_filled']}")
        # The respawned engine answers as its predecessor did, bit for bit.
        idx = list(range(RING_BITWISE_REQUESTS))
        again, _, _ = _run_burst(port, _sub_burst(single, idx), 1)
        diff = [i for i in idx if again[i] != c1_single[i]]
        check(not diff, f"the respawned engine's answers differ at requests {diff[:10]}")
        kills["cache_filled"]["bitwise_equal_requests"] = len(idx)
        shutil.rmtree(cache / "kernels", ignore_errors=True)
        kills["cache_empty"] = _kill_engine(port, log_path, single, cpu_stream=False)
        if device == "cuda":
            check(kills["cache_empty"]["nvcc_calls"] == 1,
                  f"the engine on an empty cache: {kills['cache_empty']}")
        for name, row in kills.items():
            log_timing(f"ring engine kill -9 ({name})", row)
        # A front end's kill -9: the supervisor forks its replacement.
        pids, _, _ = _ring_log(log_path)
        victim = pids["frontend 0"]
        os.kill(victim, signal.SIGKILL)
        t_kill = time.monotonic()
        while True:
            pids, _, text = _ring_log(log_path)
            if pids["frontend 0"] != victim and (
                    f"(pid {pids['frontend 0']})" in text.split("frontend 0 serving")[-1]):
                break
            check(time.monotonic() - t_kill < 60, "front end 0 was not respawned")
            time.sleep(0.01)
        frontend_respawn_s = time.monotonic() - t_kill
        for _ in range(8):
            status, _ = _http(port, "POST", "/predict", single["bodies"][0])
            check(status == 200, f"after the front end's respawn: {status}")
        log(f"ring front end respawn: {frontend_respawn_s:.3f} s")
        final = _scrape_ring(port)
        # SIGTERM while traffic flows: every answer that came back is 200,
        # every process exits 0.
        result = {}
        sub = _sub_burst(single, list(range(min(RING_DRAIN_REQUESTS, BURST_REQUESTS))))
        thread = threading.Thread(target=lambda: result.setdefault(
            "out", _tolerant_burst(port, sub, RING_KILL_CONCURRENCY)))
        thread.start()
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        thread.join(timeout=120)
        check(proc.wait(timeout=180) == 0, "the ring plane did not exit 0 after SIGTERM")
        answered = [r for r in result["out"] if r is not None]
        check(answered and all(status == 200 for status, _ in answered),
              f"answers during the drain: {sorted({s for s, _ in answered})}")
        pids, _, text = _ring_log(log_path)
        for worker in range(RING_WORKERS):
            check(f"frontend {worker} (pid {pids[f'frontend {worker}']}) exited 0" in text,
                  f"front end {worker} did not exit 0")
        check(f"engine replica 0 (pid {pids['engine']}) exited 0" in text, "the engine did not exit 0")
        port, _, single_proc, _ = planes["single"]
        single_proc.send_signal(signal.SIGTERM)
        check(single_proc.wait(timeout=120) == 0, "the single-process plane did not exit 0")
    finally:
        for _, out, proc, _ in planes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    launches = sum(r["quant_fused_launches"] for r in rows if r["plane"] == "ring")
    result = {"warmup": warm, "cuda": cuda_check, "bursts": rows, "kills": kills,
              "frontend_respawn_s": frontend_respawn_s, "final_metrics": final,
              "drain_answered": len(answered), "launches": launches}
    log_timing("ring plane", {k: result[k] for k in (
        "kills", "frontend_respawn_s", "final_metrics", "drain_answered", "launches")})
    return result


# ----------------------------------------------------------------- phase 30
# The closed lifecycle loop as configs/lifecycle_serve.toml ships it, on the
# single-process plane: drift trigger -> retrain on the controller thread
# -> the candidate shadowed on mirrored traffic -> gates -> hot swap; then,
# in this process (the JAX package offers no HTTP route for it either, its
# runbook calls controller.rollback() in process), the same loop through
# to a promotion and rollback(). Only the loop's clocks are overridden
# (LIFECYCLE_CLOCKS, as scripts/lifecycle_smoke.py sets them; the mirror
# count keeps the file's 32, so the p99 gate reads more than four
# samples), plus where its state and labeled window live.
LIFECYCLE_TOML = "configs/lifecycle_serve.toml"
LIFECYCLE_CLOCKS = ("lifecycle.tick_s=0.25", "lifecycle.cooldown_s=2",
                    "lifecycle.min_window_rows=32", "lifecycle.mirror_fraction=1.0")
# The labeled drifted window (numerics x10). At 2,000 rows the 300-step
# candidate from phase 22's seeded weights keeps an ECE of 0.11 on its
# 400-row holdout after temperature scaling, over the file's 0.1 bound; at
# 8,000 rows it calibrates to ~0.014.
LIFECYCLE_WINDOW_ROWS = 8000
LIFECYCLE_HAMMER_THREADS = 4
# Phase 30's server part only: each client pauses this long between
# requests, so fewer requests starve the retrain of the server's one GIL
# and the run stays inside its time limit. Phase 31 sends the same four
# clients unpaced to the ring plane.
LIFECYCLE_SERVER_PAUSE_S = 0.05
LIFECYCLE_WINDOWS = ("before_trigger", "retrain", "shadow", "after_swap")


def _drifted_columns(rows: int, seed: int):
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.schema.features import SCHEMA

    columns, labels = generate_synthetic(rows, seed=seed)
    for feat in SCHEMA.numeric:
        columns[feat.name] = [v * 10.0 for v in columns[feat.name]]
    return columns, labels


def _lifecycle_bodies(seed: int) -> dict:
    """Request bodies for the hammer, normal and drifted: single records
    and 8-record bodies, alternating."""
    from mlops_tpu_torch.data import generate_synthetic

    out = {}
    for drifted in (False, True):
        columns, _ = (_drifted_columns(512, seed) if drifted
                      else generate_synthetic(512, seed=seed))
        records = [{k: columns[k][i] for k in columns} for i in range(512)]
        out[drifted] = [json.dumps(records[8 * k:8 * k + (1 if k % 2 else 8)]).encode()
                        for k in range(64)]
    return out


def _hammer(port: int, bodies: dict, phase: dict, stop, samples: list,
            pause_s: float = 0.0, tenant: str = "") -> None:
    """One keep-alive client: every fourth request asks for the cheap
    class, ``pause_s`` between requests, each tagged ``x-tenant: tenant``
    when one is named; records (send time, ms, status, records)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    i = 0
    try:
        while not stop.is_set():
            batch = bodies[phase["drift"]]
            body = batch[i % len(batch)]
            headers = {"content-type": "application/json"}
            if i % BURST_CHEAP_EVERY == 0:
                headers["x-slo-class"] = "cheap"
            if tenant:
                headers["x-tenant"] = tenant
            t0 = time.monotonic()
            try:
                conn.request("POST", "/predict", body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            except (OSError, http.client.HTTPException) as err:
                status = repr(err)
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            samples.append((t0, (time.monotonic() - t0) * 1e3, status,
                            1 if body.count(b"{") == 1 else 8))
            i += 1
            if pause_s:
                stop.wait(pause_s)
    finally:
        conn.close()


def _lifecycle_scrape(port: int) -> dict:
    _, text = _http(port, "GET", "/metrics")
    text = text.decode()

    def value(name: str) -> float:
        for line in text.splitlines():
            if line.startswith(name + " ") or line.startswith(name + "{"):
                return float(line.rsplit(" ", 1)[1])
        return -1.0

    return {
        "t": time.monotonic(),
        "rows": value("mlops_tpu_rows_scored_total"),
        "launches": value("mlops_tpu_kernel_launches_total"),
        "generation": value('mlops_tpu_bundle_generation{tenant="default"}'),
        "triggers": value('mlops_tpu_drift_trigger_total{tenant="default"}'),
        "promoted": value('mlops_tpu_promotions_total{tenant="default",outcome="promoted"}'),
        "rejected": value('mlops_tpu_promotions_total{tenant="default",outcome="rejected"}'),
    }


class _PlaneLog:
    """A plane subprocess whose output a thread copies into a log file,
    keeping (arrival time, line) for everything but the per-request
    structured events."""

    def __init__(self, cmd: list[str], env: dict, path: Path) -> None:
        self.path = path
        self.events: list[tuple[float, str]] = []
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self._pump = threading.Thread(target=self._copy, daemon=True)
        self._pump.start()

    def _copy(self) -> None:
        with open(self.path, "w") as out:
            for line in iter(self.proc.stdout.readline, ""):
                if not line.startswith('{"service_name"'):
                    self.events.append((time.monotonic(), line))
                out.write(line)
                out.flush()

    def tail(self) -> str:
        return "".join(line for _, line in self.events[-40:])

    def find(self, pattern: str, after: float = 0.0) -> tuple[float, str] | None:
        return next(((t, line) for t, line in list(self.events)
                     if t >= after and pattern in line), None)

    def wait(self, pattern: str, seconds: float, after: float = 0.0, each=None) -> float:
        """The arrival time of the first line holding ``pattern`` (after
        ``after``); ``each()`` runs between looks."""
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            hit = self.find(pattern, after)
            if hit is not None:
                return hit[0]
            check(self.proc.poll() is None,
                  f"the plane exited ({self.proc.returncode}); its last lines:\n{self.tail()}")
            if each is not None:
                each()
            time.sleep(0.1)
        raise SmokeFailure(f"no {pattern!r} in {seconds:.0f} s; the plane's last lines:\n"
                           f"{self.tail()}")

    def stop(self, timeout: float = 120) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=30)
        self._pump.join(timeout=30)
        return rc


def _lifecycle_server(bundle_dir: Path, window: Path, device: str,
                      extra: tuple[str, ...]) -> dict:
    """Part one: ``serve --config configs/lifecycle_serve.toml`` in a
    subprocess under the hammer, normal traffic and then drifted, until a
    promotion; SIGTERM; the four windows' latency, the quant_fused
    launches in each, the rows /metrics counted against the records
    answered."""
    import numpy as np

    work = WORK / "lifecycle_server"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    port = _free_port()
    cmd = [sys.executable, "-m", "mlops_tpu_torch", "serve", "--config", LIFECYCLE_TOML,
           "serve.host=127.0.0.1", f"serve.port={port}", f"serve.device={device}",
           "serve.tier_routing=true", f"lifecycle.dir={work / 'state'}",
           f"lifecycle.labeled_path={window}", *LIFECYCLE_CLOCKS, *extra]
    log(f"lifecycle server: {' '.join(cmd[2:])} (MODEL_DIRECTORY={bundle_dir})")
    plane = _PlaneLog(cmd, dict(os.environ, PYTHONPATH=str(ROOT), MODEL_DIRECTORY=str(bundle_dir),
                                PYTHONFAULTHANDLER="1"), work / "server.log")
    proc = plane.proc

    def scrape():
        scrapes.append(_lifecycle_scrape(port))

    bodies = _lifecycle_bodies(seed=61)
    phase = {"drift": False}
    stop = threading.Event()
    samples: list = []
    scrapes: list = []
    clients = []
    try:
        _wait_ready(port, proc, "lifecycle server")
        plane.wait("lifecycle controller started", 30)
        first = _lifecycle_scrape(port)
        check(first["generation"] == 1 and first["triggers"] == 0,
              f"lifecycle server before traffic: {first}")
        t_start = time.monotonic()
        clients = [threading.Thread(target=_hammer, args=(port, bodies, phase, stop, samples,
                                                          LIFECYCLE_SERVER_PAUSE_S),
                                    daemon=True) for _ in range(LIFECYCLE_HAMMER_THREADS)]
        for client in clients:
            client.start()
        time.sleep(3.0)
        scrapes.append(_lifecycle_scrape(port))
        check(scrapes[-1]["triggers"] == 0, "lifecycle server: a trigger on normal traffic")
        phase["drift"] = True
        t_trigger = plane.wait("lifecycle trigger fired", 120, each=scrape)
        t_shadow = plane.wait("; shadowing", 300, each=scrape)
        t_swap = plane.wait("candidate promoted: generation", 300, each=scrape)
        after_swap = _lifecycle_scrape(port)
        scrapes.append(after_swap)
        time.sleep(3.0)  # traffic on the promoted bundle
        stop.set()
        for client in clients:
            client.join(timeout=120)
        t_end = time.monotonic()
        records = sum(s[3] for s in samples)
        deadline = time.monotonic() + 30
        while (final := _lifecycle_scrape(port))["rows"] != records:
            if time.monotonic() > deadline:
                break  # the check below names both numbers
            time.sleep(0.5)
        rc = plane.stop()
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = (work / "server.log").read_text()
    check(rc == 0 and "drained; exiting" in text,
          f"lifecycle server exited {rc} without a clean drain; see {work / 'server.log'}")
    bad = [s for s in samples if s[2] != 200]
    check(not bad, f"lifecycle server: {len(bad)} non-200 answers, first {bad[:3]}")
    check(final["rows"] == records,
          f"lifecycle server: /metrics rows {final['rows']} != records answered {records}")
    check(final["generation"] >= 2 and final["promoted"] >= 1,
          f"lifecycle server: no promotion on /metrics: {final}")
    bounds = (t_start, t_trigger, t_shadow, t_swap, t_end)

    def launches_at(t: float) -> float:
        return next((s["launches"] for s in sorted(scrapes, key=lambda s: s["t"])
                     if s["t"] >= t), final["launches"])

    windows = {}
    for name, lo, hi in zip(LIFECYCLE_WINDOWS, bounds[:-1], bounds[1:]):
        lat = [s[1] for s in samples if lo <= s[0] < hi]
        windows[name] = {
            "seconds": hi - lo, "requests": len(lat),
            "p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat else None,
            "quant_fused_launches": launches_at(hi) - launches_at(lo),
        }
    windows["after_swap"]["quant_fused_launches"] = final["launches"] - after_swap["launches"]
    if device == "cuda":
        check(windows["before_trigger"]["quant_fused_launches"] > 0,
              "lifecycle server: quant_fused never launched before the swap")
    check(windows["after_swap"]["quant_fused_launches"] == 0,
          "lifecycle server: quant_fused launched after the promotion to a bundle "
          "without a quant tier")
    built = plane.find("; shadowing")[1].strip()
    promoted = plane.find("candidate promoted")[1].strip()
    result = {
        "requests": len(samples), "records": records, "non_200": len(bad),
        "windows": windows, "candidate_built": built, "promotion": promoted,
        "rejections_before_promotion": final["rejected"],
        "trigger_to_swap_s": t_swap - t_trigger,
        "final_metrics": {k: final[k] for k in ("generation", "triggers", "promoted",
                                                "rejected", "rows", "launches")},
    }
    log_timing("lifecycle server", result)
    return result


def _lifecycle_in_process(bundle_dir: Path, window: Path, device: str,
                          extra: tuple[str, ...]) -> dict:
    """Part two, in this process: the engine and LifecycleController on
    the card from the same bundle and window, run_once driven with normal
    and then drifted traffic (every fourth request on the cheap tier)
    through to a promotion, then controller.rollback(). Holds the
    candidate's holdout predictions on the card against the CPU route, a
    row's answer after the swap against the candidate's eager route and
    after the rollback against the incumbent's (bitwise), and the live
    aggregate's rows against the rows served across both."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.data.ingest import load_table_columns
    from mlops_tpu_torch.lifecycle.controller import LifecycleController
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.server import Metrics
    from mlops_tpu_torch.train.pipeline import split_dataset

    work = WORK / "lifecycle_inprocess"
    shutil.rmtree(work, ignore_errors=True)
    config = load_config([f"serve.device={device}", f"lifecycle.dir={work}",
                          f"lifecycle.labeled_path={window}", *LIFECYCLE_CLOCKS, *extra],
                         ROOT / LIFECYCLE_TOML)
    incumbent = load_bundle(bundle_dir)
    engine = InferenceEngine(incumbent, tier_routing=True, device=device)
    engine.warmup()
    ctrl = LifecycleController(engine, config)
    normal = incumbent.preprocessor.encode(generate_synthetic(512, seed=71)[0])
    drifted = incumbent.preprocessor.encode(_drifted_columns(512, seed=71)[0])
    served = {"rows": 0}

    def serve_rows(ds, lo: int, n: int = 64) -> None:
        for k, start in enumerate(range(lo, lo + n, 8)):
            rows = ds.cat_ids[start:start + 8], ds.numeric[start:start + 8]
            tier = "quant" if k % BURST_CHEAP_EVERY == 0 else None
            engine.predict_arrays(*rows, tier=tier)
            served["rows"] += 8

    def launches() -> float:
        return _metric(Metrics().render(engine.dispatch_counts()),
                       "mlops_tpu_kernel_launches_total")

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counts = {"start": launches()}
    serve_rows(normal, 0)
    ctrl.run_once()
    shadow_pools = None
    status = ctrl.status()
    for tick in range(40):
        serve_rows(drifted, (64 * tick) % 448)
        if status["state"] == "shadowing" and ctrl._shadow is not None:
            shadow = ctrl._shadow
            shadow_pools = {"candidate": shadow.engine._pool_bytes,
                            "incumbent": shadow._incumbent._pool_bytes}
        counts["before_swap"] = launches()
        status = ctrl.run_once()
        if status["promotions"]["promoted"]:
            break
    check(status["promotions"]["promoted"] == 1 and engine.bundle_generation == 2,
          f"in-process loop: no promotion in 40 ticks: {status}")
    swap = dict(engine.swap_stats)
    peak = ({"max_memory_allocated": torch.cuda.max_memory_allocated(),
             "max_memory_reserved": torch.cuda.max_memory_reserved(),
             "graph_pools_bytes": {"live_before_swap": engine.warmup_stats.get(
                 "graph_pool_bytes"), "promotion": swap["graph_pool_bytes"],
                 "shadow": shadow_pools}}
            if device == "cuda" else None)
    candidate = load_bundle(status["last_retrain"]["candidate"])
    labeled_cols, labeled = load_table_columns(window)
    _, holdout = split_dataset(incumbent.preprocessor.encode(labeled_cols, labeled), 0.2)
    cpu = InferenceEngine(candidate, device="cpu")
    card = InferenceEngine(candidate, device=device, cuda_graphs=False)
    pred_err = 0.0
    for lo in range(0, holdout.n, 256):
        rows = holdout.cat_ids[lo:lo + 256], holdout.numeric[lo:lo + 256]
        got = np.asarray(card.predict_arrays(*rows)["predictions"])
        want = np.asarray(cpu.predict_arrays(*rows)["predictions"])
        pred_err = max(pred_err, float(np.abs(got - want).max()))
    check(pred_err <= EXACT_PRED_ATOL + 1e-6,
          f"in-process loop: the candidate on the card differs from the CPU route "
          f"by {pred_err:.3g} > {EXACT_PRED_ATOL}")
    probe = drifted.cat_ids[:8], drifted.numeric[:8]
    for tier in (None, "quant"):
        got = engine.predict_arrays(*probe, tier=tier)
        served["rows"] += 8
        check(got == card.predict_arrays(*probe),
              f"in-process loop: after the swap a {tier or 'default'}-tier answer is not "
              "the candidate's eager route's, bitwise")
    counts["after_swap"] = launches()
    check(counts["after_swap"] == counts["before_swap"],
          "in-process loop: quant_fused launched after the promotion")
    generation = ctrl.rollback()
    rollback = dict(engine.swap_stats)
    check(generation == 3 and engine.available_tiers == ("quant", "exact"),
          f"in-process loop: rollback gave generation {generation}, tiers "
          f"{engine.available_tiers}")
    answers = {}
    for tier in (None, "quant"):
        answers[tier] = engine.predict_arrays(*probe, tier=tier)
        served["rows"] += 8
    counts["after_rollback"] = launches()  # before the eager route launches
    incumbent_eager = InferenceEngine(incumbent, tier_routing=True, device=device,
                                      cuda_graphs=False)
    for tier, got in answers.items():
        check(got == incumbent_eager.predict_arrays(*probe, tier=tier),
              f"in-process loop: after the rollback a {tier or 'default'}-tier answer is "
              "not the incumbent's eager route's, bitwise")
    if device == "cuda":
        check(counts["before_swap"] > counts["start"], "in-process loop: quant_fused "
              "never launched before the swap")
        check(counts["after_rollback"] == counts["after_swap"] + 1,
              "in-process loop: quant_fused did not launch once after the rollback")
    rows = engine.monitor_snapshot()["rows"]
    check(rows == served["rows"], f"in-process loop: the live aggregate counted {rows} "
          f"rows, {served['rows']} were served across the swap and the rollback")
    ctrl.stop()
    report = status["last_report"]
    result = {
        "retrain": status["last_retrain"],
        "retrain_step_ms": 1e3 * status["last_retrain"]["fit_s"]
        / config.lifecycle.retrain_steps,
        "gates": report["gates"], "report": {k: report[k] for k in (
            "auc_candidate", "auc_incumbent", "auc_delta", "ece_candidate",
            "p50_candidate_ms", "p50_incumbent_ms", "p99_candidate_ms",
            "p99_incumbent_ms", "mirrors", "mirror_drops", "holdout_rows")},
        "swap": swap, "rollback": rollback, "peak_memory": peak,
        "candidate_vs_cpu_max_abs_err": pred_err, "rows": rows,
        "quant_fused_launches": {
            "before_swap": counts["before_swap"] - counts["start"],
            "after_swap": counts["after_swap"] - counts["before_swap"],
            "after_rollback": counts["after_rollback"] - counts["after_swap"]},
    }
    log_timing("lifecycle in process", result)
    return result


def phase_lifecycle(bundle_dir: Path, device: str = "cuda",
                    extra: tuple[str, ...] = ()) -> dict:
    """Phase 30: the labeled drifted window, then the loop in a server
    subprocess and in this process (``_lifecycle_server``,
    ``_lifecycle_in_process``)."""
    from mlops_tpu_torch.data.ingest import write_csv_columns

    window = WORK / "lifecycle_window.csv"
    write_csv_columns(window, *_drifted_columns(LIFECYCLE_WINDOW_ROWS, seed=3))
    server = _lifecycle_server(bundle_dir, window, device,
                               (f"lifecycle.retrain_steps={LOOP_RETRAIN_STEPS}", *extra))
    in_process = _lifecycle_in_process(bundle_dir, window, device, extra)
    launches = {**{f"server_{k}": v["quant_fused_launches"]
                   for k, v in server["windows"].items()},
                **{f"in_process_{k}": v
                   for k, v in in_process["quant_fused_launches"].items()}}
    return {"server": server, "in_process": in_process, "launches": launches}


# ----------------------------------------------------------------- phase 31
# The lifecycle loop on the ring plane, as the serving image starts it with
# configs/lifecycle_serve.toml mounted: the image's MLOPS_TPU_SERVE_WORKERS=2
# and MLOPS_TPU_CACHE_DIR win over the file's workers = 0, and the loop
# runs in the engine process. Phase 30's bundle, window, clocks and traffic,
# so the two planes compare.
RING_LOOP_BITWISE_REQUESTS = 32  # sent one at a time before the trigger and after the respawn
LOOP_RETRAIN_STEPS = 75  # of the file's 300, in phase 30's server and phase 31


def _lifecycle_block(text: str, tenants: tuple[str, ...] = ("default",)) -> list[str]:
    """The lifecycle series of ``tenants`` in a /metrics text."""
    return [line for line in text.splitlines()
            if any(f'tenant="{t}"' in line for t in tenants) and any(
                name in line for name in ("bundle_generation", "drift_trigger", "shadow_auc",
                                          "promotions_total", "lifecycle_"))]


def _every_front_end(port: int, workers: int,
                     tenants: tuple[str, ...] = ("default",)) -> list[str]:
    """Scrapes on new connections until each of the ``workers`` front
    ends has answered some (the per-worker /metrics counters tell which);
    every scrape's lifecycle block of ``tenants`` must be the same.
    Returns it."""
    def answered(text: str) -> dict[str, float]:
        out = {}
        for line in text.splitlines():
            if line.startswith('mlops_tpu_requests_total{route="/metrics",status="200",worker="'):
                worker = line.split('worker="')[1].split('"')[0]
                out[worker] = out.get(worker, 0.0) + float(line.rsplit(" ", 1)[1])
        return out

    start = answered(_http(port, "GET", "/metrics")[1].decode())
    blocks = []
    for _ in range(200):
        text = _http(port, "GET", "/metrics")[1].decode()
        blocks.append(_lifecycle_block(text, tenants))
        counts = answered(text)
        if all(counts.get(str(w), 0) > start.get(str(w), 0) + 1 for w in range(workers)):
            break
    check(all(counts.get(str(w), 0) > start.get(str(w), 0) + 1 for w in range(workers)),
          f"not every front end answered a scrape: {counts} from {start}")
    odd = next((block for block in blocks if block != blocks[0]), None)
    check(odd is None, "the front ends render different lifecycle blocks: "
          f"{sorted(set(blocks[0]) ^ set(odd or ()))}")
    return blocks[0]


def _sequential(port: int, bodies: list[bytes]) -> list[tuple[int, bytes]]:
    """One keep-alive connection, one request at a time (every fourth
    cheap): (status, body) of each."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = []
    try:
        for i, body in enumerate(bodies):
            headers = {"content-type": "application/json"}
            if i % BURST_CHEAP_EVERY == 0:
                headers["x-slo-class"] = "cheap"
            conn.request("POST", "/predict", body=body, headers=headers)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
    finally:
        conn.close()
    return out


def _retrain_steps(extra: tuple[str, ...]) -> int:
    import tomllib

    for item in extra:
        if item.startswith("lifecycle.retrain_steps="):
            return int(item.split("=", 1)[1])
    with open(ROOT / LIFECYCLE_TOML, "rb") as f:
        return int(tomllib.load(f)["lifecycle"]["retrain_steps"])


def _warm_cache(bundle_dir: Path, cache: Path, device: str) -> None:
    """``warmup --cache-dir`` unless the cache holds the bundle's kernel
    library already (phase 29 fills it)."""
    if device != "cuda" or list((cache / "kernels").glob("libquant_fused-*.so")):
        return
    proc = subprocess.run(_cli(["warmup", "--cache-dir", str(cache)]), cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT),
                                   **_image_env(bundle_dir, cache, 0, RING_WORKERS, device)),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"warmup: {proc.stderr[-3000:]}")


def phase_ring_lifecycle(bundle_dir: Path, device: str = "cuda",
                         extra: tuple[str, ...] = ()) -> dict:
    """Phase 31: ``serve --config configs/lifecycle_serve.toml`` with the
    serving image's environment (``MLOPS_TPU_SERVE_WORKERS=2``,
    ``MLOPS_TPU_CACHE_DIR`` on a warmed cache) and tier routing on phase
    22's bundle, the retrain cut to LOOP_RETRAIN_STEPS; the engine
    process alone holds the card and builds no kernel. 32 requests one at a time, then phase 30's four clients,
    normal traffic and then drifted, through the engine-side trigger,
    retrain, shadow and promotion; every answer 200; per window (before
    the trigger, retrain, shadow, after the swap) p50 / p99, requests/s,
    non-200 and ``quant_fused`` launches from the ring's /metrics; every
    front end's lifecycle block equal at generation 2; kill -9 of the
    engine: the counters never go back, the respawn serves the fork-time
    bundle at generation 1 and answers the 32 requests bitwise as before
    the trigger (``quant_fused`` launching again); SIGTERM under traffic:
    every child exits 0."""
    import numpy as np

    from mlops_tpu_torch.data.ingest import write_csv_columns

    root = WORK / "ring_lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    window = WORK / "lifecycle_window.csv"
    if not window.is_file():
        write_csv_columns(window, *_drifted_columns(LIFECYCLE_WINDOW_ROWS, seed=3))
    cache = WORK / "ring" / "cache"
    _warm_cache(bundle_dir, cache, device)
    port = _free_port()
    cut = f"lifecycle.retrain_steps={LOOP_RETRAIN_STEPS}"
    cmd = _cli(["serve", "--config", LIFECYCLE_TOML, f"lifecycle.dir={root / 'state'}",
                f"lifecycle.labeled_path={window}", *LIFECYCLE_CLOCKS, cut, *extra])
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONFAULTHANDLER="1",
               **_image_env(bundle_dir, cache, port, RING_WORKERS, device))
    log(f"ring lifecycle plane: {' '.join(cmd[2:])} (MLOPS_TPU_SERVE_WORKERS={RING_WORKERS})")
    plane = _PlaneLog(cmd, env, root / "plane.log")
    bodies = _lifecycle_bodies(seed=61)
    probe = bodies[False][:RING_LOOP_BITWISE_REQUESTS]
    phase = {"drift": False}
    stop = threading.Event()
    samples: list = []
    scrapes: list = []
    clients: list = []

    def scrape():
        scrapes.append(_lifecycle_scrape(port))

    try:
        _wait_ready(port, plane.proc, "ring lifecycle plane")
        plane.wait("lifecycle controller started", 60)
        pids, ready, text = _ring_log(plane.path)
        check(len(ready) == 1 and (device != "cuda" or ready[0]["nvcc_calls"] == 0),
              f"the ring engine's start: {ready}")
        check("tiers=quant,exact" in text, "the ring engine does not hold both tiers")
        members = {plane.proc.pid, *_children(plane.proc.pid)}
        holders = sorted(pid for pid in members if _holds_card(pid))
        if device == "cuda":
            check(holders == [pids["engine"]],
                  f"processes holding the card {holders}, engine {pids['engine']}")
        first = _lifecycle_scrape(port)
        check(first["generation"] == 1 and first["triggers"] == 0,
              f"ring lifecycle plane before traffic: {first}")
        before = _sequential(port, probe)
        check(all(status == 200 for status, _ in before),
              f"ring lifecycle plane: {[s for s, _ in before]}")
        scrape()
        t_start = time.monotonic()
        clients = [threading.Thread(target=_hammer, args=(port, bodies, phase, stop, samples),
                                    daemon=True) for _ in range(LIFECYCLE_HAMMER_THREADS)]
        for client in clients:
            client.start()
        time.sleep(3.0)
        scrape()
        check(scrapes[-1]["triggers"] == 0, "ring lifecycle plane: a trigger on normal traffic")
        phase["drift"] = True
        t_trigger = plane.wait("lifecycle trigger fired", 120, each=scrape)
        t_shadow = plane.wait("; shadowing", 300, after=t_trigger, each=scrape)
        t_swap = plane.wait("candidate promoted: generation", 300, after=t_shadow, each=scrape)
        after_swap = _lifecycle_scrape(port)
        scrapes.append(after_swap)
        time.sleep(3.0)  # traffic on the promoted bundle
        stop.set()
        for client in clients:
            client.join(timeout=120)
        t_end = time.monotonic()
        final = _lifecycle_scrape(port)
        scrapes.append(final)
        block = _every_front_end(port, RING_WORKERS)
        check('mlops_tpu_bundle_generation{tenant="default"} 2' in block,
              f"the front ends' lifecycle block after the promotion: {block}")
        # kill -9 of the engine after the promotion.
        kill_before = _lifecycle_scrape(port)
        incarnation = _scrape_ring(port)["engine_incarnation"]
        os.kill(pids["engine"], signal.SIGKILL)
        t_kill = time.monotonic()
        while True:
            try:
                if (_scrape_ring(port)["engine_incarnation"] > incarnation
                        and _http(port, "GET", "/healthz/ready")[0] == 200
                        and _lifecycle_scrape(port)["generation"] == 1):
                    break
            except OSError:
                pass
            check(time.monotonic() - t_kill < 300, "the engine never came back after kill -9")
            time.sleep(0.05)
        kill_to_ready = time.monotonic() - t_kill
        respawned = _lifecycle_scrape(port)
        again = _sequential(port, probe)
        after_respawn = _lifecycle_scrape(port)
        # SIGTERM while traffic flows.
        stop.clear()
        phase["drift"] = False
        drain_samples: list = []
        drainers = [threading.Thread(target=_hammer,
                                     args=(port, bodies, phase, stop, drain_samples),
                                     daemon=True) for _ in range(2)]
        for client in drainers:
            client.start()
        time.sleep(0.5)
        rc = plane.stop()
        stop.set()
        for client in drainers:
            client.join(timeout=60)
    finally:
        stop.set()
        if plane.proc.poll() is None:
            plane.proc.kill()
            plane.proc.wait(timeout=30)
    bad = [s for s in samples if s[2] != 200]
    check(not bad, f"ring lifecycle plane: {len(bad)} non-200 answers, first {bad[:3]}")
    # Two readers of the monitor in one process (the controller's windows
    # and the ring's telemetry): the rows never go back on /metrics.
    for key in ("rows", "triggers", "launches"):
        seen = [s[key] for s in sorted(scrapes, key=lambda s: s["t"])]
        check(seen == sorted(seen), f"ring lifecycle plane: /metrics {key} went back")
    for key in ("triggers", "promoted", "rejected", "rows", "launches"):
        check(respawned[key] >= kill_before[key],
              f"ring lifecycle plane: {key} went back across the engine kill "
              f"({kill_before[key]} -> {respawned[key]})")
    check(respawned["generation"] == 1,
          f"the respawned engine serves generation {respawned['generation']}, not 1")
    diff = [i for i, (a, b) in enumerate(zip(before, again)) if a != b]
    check(not diff, f"the respawned engine's answers differ from the pre-trigger ones at {diff}")
    pids_after, _, text = _ring_log(plane.path)
    check(rc == 0, f"the ring lifecycle plane exited {rc} after SIGTERM")
    for worker in range(RING_WORKERS):
        check(f"frontend {worker} (pid {pids_after[f'frontend {worker}']}) exited 0" in text,
              f"front end {worker} did not exit 0")
    check(f"engine replica 0 (pid {pids_after['engine']}) exited 0" in text, "the engine did not exit 0")
    answered = [s for s in drain_samples if isinstance(s[2], int)]
    check(all(s[2] == 200 for s in answered),
          f"answers during the drain: {sorted({s[2] for s in answered})}")
    bounds = (t_start, t_trigger, t_shadow, t_swap, t_end)

    def launches_at(t: float) -> float:
        return next((s["launches"] for s in sorted(scrapes, key=lambda s: s["t"])
                     if s["t"] >= t), final["launches"])

    windows = {}
    for name, lo, hi in zip(LIFECYCLE_WINDOWS, bounds[:-1], bounds[1:]):
        inside = [s for s in samples if lo <= s[0] < hi]
        lat = [s[1] for s in inside]
        windows[name] = {
            "seconds": hi - lo, "requests": len(lat),
            "requests_per_s": len(lat) / (hi - lo) if hi > lo else None,
            "p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat else None,
            "non_200": sum(s[2] != 200 for s in inside),
            "quant_fused_launches": launches_at(hi) - launches_at(lo),
        }
    windows["after_swap"]["quant_fused_launches"] = final["launches"] - after_swap["launches"]
    launches_after_respawn = after_respawn["launches"] - respawned["launches"]
    if device == "cuda":
        check(windows["before_trigger"]["quant_fused_launches"] > 0,
              "ring lifecycle plane: quant_fused never launched before the swap")
        check(launches_after_respawn > 0,
              "ring lifecycle plane: quant_fused did not launch after the respawn")
    check(windows["after_swap"]["quant_fused_launches"] == 0,
          "ring lifecycle plane: quant_fused launched after the promotion to a bundle "
          "without a quant tier")
    built = plane.find("; shadowing")[1]
    wall_s, rest = built.split(" built in ", 1)[1].split("s (fit ", 1)
    fit_s, rest = rest.split("s; warm: ", 1)
    warm_mode, warm_s = rest.split("s)")[0].split()
    steps = _retrain_steps((*extra, cut))
    result = {
        "requests": len(samples), "records": sum(s[3] for s in samples), "non_200": len(bad),
        "windows": windows, "trigger_to_swap_s": t_swap - t_trigger,
        "retrain": {"wall_s": float(wall_s), "fit_s": float(fit_s), "steps": steps,
                    "step_ms": 1e3 * float(fit_s) / steps, "warm_mode": warm_mode,
                    "warm_s": float(warm_s)},
        "promotion": plane.find("candidate promoted")[1].strip(),
        "front_end_block": block, "holding_the_card": holders, "engine_pid": pids["engine"],
        "engine_nvcc_calls": ready[0]["nvcc_calls"],
        "kill": {"kill_to_ready_s": kill_to_ready, "before": kill_before,
                 "after": respawned, "bitwise_equal_requests": len(probe),
                 "quant_fused_launches_after_respawn": launches_after_respawn},
        "drain_answered": len(answered),
    }
    log_timing("ring lifecycle", result)
    return result


# ----------------------------------------------------------------- phase 32
# A card twin of scripts/chaos_smoke.py on the port's paths: one ring plane
# as phase 31 starts it, armed through MLOPS_TPU_FAULTS with the JAX plan
# format, then short subprocesses for the torn writes and the bad cache
# bytes.
CHAOS_ALLOWED = {200, 413, 422, 503, 504}
CHAOS_STALL_S = 0.6  # each of the first CHAOS_STALL_FIRES dispatches of a kind stalls
CHAOS_STALL_FIRES = 4
CHAOS_BUDGET_MS = 200  # x-request-deadline-ms of the stalled requests
CHAOS_EXIT_TICKS = 60  # the engine kills itself at this 0.5 s main-loop tick
CHAOS_BITWISE_REQUESTS = 16
CHAOS_PLAN = f"""\
seed = 42

[[fault]]
point = "serve.engine.dispatch*"
mode = "delay"
delay_s = {CHAOS_STALL_S}
max_fires = {CHAOS_STALL_FIRES}

[[fault]]
point = "lifecycle.retrain"
mode = "raise"
max_fires = 2
message = "injected retrain failure"

[[fault]]
point = "serve.engine.exit"
mode = "kill"
after = {CHAOS_EXIT_TICKS}
max_fires = 1
"""


def _budgeted_burst(port: int, body: bytes, n: int) -> list[tuple[int, float]]:
    """``n`` concurrent requests, each on its own connection, with a
    ``CHAOS_BUDGET_MS`` deadline: (status, ms) of each."""
    out: list = [None] * n

    def one(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        t0 = time.monotonic()
        try:
            conn.request("POST", "/predict", body=body, headers={
                "content-type": "application/json",
                "x-request-deadline-ms": str(CHAOS_BUDGET_MS)})
            resp = conn.getresponse()
            resp.read()
            out[i] = (resp.status, (time.monotonic() - t0) * 1e3)
        finally:
            conn.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    check(all(o is not None for o in out), "a budgeted request hung")
    return out


def _counters(port: int) -> dict[str, float]:
    """Every counter sample of /metrics by series name and labels."""
    text = _http(port, "GET", "/metrics")[1].decode()
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            if kinds.get(series.split("{")[0]) == "counter":
                out[series] = float(value)
    return out


_CHAOS_RESERVOIR_KILL = """
import numpy as np
from mlops_tpu_torch import faults
from mlops_tpu_torch.lifecycle.retrain import SampleReservoir
from mlops_tpu_torch.schema.features import SCHEMA
res = SampleReservoir(64, {state!r})
res.add_batch(np.zeros((40, SCHEMA.num_categorical), np.int32),
              np.zeros((40, SCHEMA.num_numeric), np.float32))
res.save()
faults.arm(faults.FaultPlan.from_rules(
    [{{"point": "lifecycle.reservoir.midwrite", "mode": "kill"}}]))
res.add_batch(np.ones((9, SCHEMA.num_categorical), np.int32),
              np.ones((9, SCHEMA.num_numeric), np.float32))
res.save()
raise SystemExit("the kill fault did not fire")
"""

_CHAOS_ATOMIC_KILL = """
from mlops_tpu_torch import faults
from mlops_tpu_torch.utils.io import atomic_write
atomic_write({target!r}, b"GOOD" * 1024)
faults.arm(faults.FaultPlan.from_rules(
    [{{"point": "io.atomic_write.midwrite", "mode": "kill"}}]))
atomic_write({target!r}, b"TORN" * 4096)
raise SystemExit("the kill fault did not fire")
"""

_CHAOS_PERSIST_KILL = """
from mlops_tpu_torch import faults
from mlops_tpu_torch.ops import cuda_build
cuda_build.set_cache_dir({cache!r})
faults.arm(faults.FaultPlan.from_rules(
    [{{"point": "compilecache.persist.midwrite", "mode": "kill"}}]))
cuda_build.build_shared_library(cuda_build.PACKAGE_DIR / "csrc" / "quant_fused.cu",
                                "quant_fused")
raise SystemExit("the kill fault did not fire")
"""

_CHAOS_CORRUPT_READ = """
import json
import torch
from mlops_tpu_torch import faults
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.ops import cuda_build, quant_kernel
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
cuda_build.set_cache_dir({cache!r})
faults.arm(faults.FaultPlan.from_rules(
    [{{"point": "compilecache.read", "mode": "corrupt", "flip_bits": 8}}]))
dev = torch.device("cuda")
columns, _ = generate_synthetic(5000, seed=0)
prep = Preprocessor.fit(columns)
mon = fit_monitor(prep.encode(columns)).to(dev)
qp = {{k: v.to(dev) for k, v in quantize_student(init_quant_master(0)).items()}}
ds = prep.encode(generate_synthetic(512, seed=1, drift=0.4)[0])
cat = torch.from_numpy(ds.cat_ids.reshape(64, 8, -1)).to(dev)
num = torch.from_numpy(ds.numeric.reshape(64, 8, -1)).to(dev)
mask = torch.ones((64, 8), dtype=torch.bool, device=dev)
args = (qp["embed"], qp["w1_q"], qp["w1_s"], qp["b1"], qp["w2_q"], qp["w2_s"], qp["b2"],
        mon.num_ref_sorted, mon.num_ref_cdf, mon.out_mean, mon.out_precision,
        mon.out_threshold, torch.tensor(1.3, device=dev), cat, num, mask)
kp, kf, kc, kk = quant_kernel.fused_core_cuda(*args)
torch.cuda.synchronize()
rp, rf, rc, rk = quant_kernel.fused_core_reference(*args)
print(json.dumps({{"discards": cuda_build.cache_discards(), "nvcc_calls": cuda_build.nvcc_calls(),
                  "counts_and_ks_exact": bool(torch.equal(kc, rc) and torch.equal(kk, rk)),
                  "max_abs_err": float((kp - rp).abs().max()),
                  "trace": faults.active_plan().trace()}}))
"""


def _chaos_script(name: str, script: str, expect_kill: bool, env: dict | None = None
                  ) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})))
    if expect_kill:
        check(proc.returncode == -signal.SIGKILL,
              f"{name}: exit {proc.returncode}, not SIGKILL\n{proc.stderr[-2000:]}")
    else:
        check(proc.returncode == 0, f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return proc


def _torn_writes(root: Path, device: str) -> dict:
    """A kill at each mid-write point in a subprocess: no torn file lands.
    The reservoir keeps its prior snapshot (40 rows), the atomic write its
    prior bytes, and the kernel cache holds no library under its final
    name (the persist kill needs nvcc: the card machine's)."""
    import numpy as np

    out = {}
    state = root / "reservoir"
    _chaos_script("reservoir mid-write kill",
                  _CHAOS_RESERVOIR_KILL.format(state=str(state)), expect_kill=True)
    with np.load(state / "reservoir.npz") as data:
        rows = int(data["cat"].shape[0])
        clean = bool((data["cat"] == 0).all())
    check(rows == 40 and clean, f"the reservoir after a mid-write kill: {rows} rows")
    out["reservoir_rows_kept"] = rows
    target = root / "record.bin"
    _chaos_script("atomic_write mid-write kill",
                  _CHAOS_ATOMIC_KILL.format(target=str(target)), expect_kill=True)
    check(target.read_bytes() == b"GOOD" * 1024, "atomic_write left a torn file")
    out["atomic_write_kept_bytes"] = len(target.read_bytes())
    if device == "cuda":
        cache = root / "persist_cache"
        _chaos_script("kernel cache persist kill",
                      _CHAOS_PERSIST_KILL.format(cache=str(cache)), expect_kill=True)
        landed = [p.name for p in (cache / "kernels").glob("*.so") if ".tmp." not in p.name]
        check(not landed, f"a torn kernel library landed: {landed}")
        out["persist_kill_libraries_landed"] = 0
    return out


def _bad_cache_bytes(root: Path, device: str) -> dict | None:
    """Seeded bit flips on the cached ``quant_fused`` library's read: a
    counted discard, one nvcc rebuild, and the rebuilt kernel's answers
    against its plain version (counts and K-S exact, predictions 1e-6)."""
    if device != "cuda":
        return None
    cache = root / "corrupt_cache"
    shutil.copytree(WORK / "ring" / "cache" / "kernels", cache / "kernels")
    proc = _chaos_script("corrupt cache read", _CHAOS_CORRUPT_READ.format(cache=str(cache)),
                         expect_kill=False)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(report["discards"] == 1 and report["nvcc_calls"] == 1,
          f"corrupt cache read: {report}")
    check(report["counts_and_ks_exact"] and report["max_abs_err"] <= PRED_ATOL,
          f"the rebuilt kernel disagrees with its plain version: {report}")
    return report


def phase_chaos(bundle_dir: Path, device: str = "cuda", extra: tuple[str, ...] = ()) -> dict:
    """Phase 32: phase 31's plane armed with ``CHAOS_PLAN`` through
    ``MLOPS_TPU_FAULTS`` (every process of the plane arms at import).
    Stall: budgeted requests answer 504 inside their deadline while the
    first dispatches stall, 200 after. Breaker: two injected retrain
    failures on drifted traffic open ``mlops_tpu_lifecycle_breaker_open``
    on every front end, and no retrain runs. Engine death: the engine
    kills itself at main-loop tick ``CHAOS_EXIT_TICKS``; the respawn
    answers bitwise as before and no counter goes back. Then the torn
    writes and the bad cache bytes in subprocesses. Every status in
    {200, 413, 422, 503, 504}; SIGTERM drains, every child exits 0."""
    root = WORK / "chaos"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    plan = root / "chaos.toml"
    plan.write_text(CHAOS_PLAN)
    window = WORK / "lifecycle_window.csv"
    cache = WORK / "ring" / "cache"
    _warm_cache(bundle_dir, cache, device)
    port = _free_port()
    cmd = _cli(["serve", "--config", LIFECYCLE_TOML, f"lifecycle.dir={root / 'state'}",
                f"lifecycle.labeled_path={window}", *LIFECYCLE_CLOCKS,
                "lifecycle.breaker_failures=2", "lifecycle.breaker_cooldown_s=600", *extra])
    env = dict(os.environ, PYTHONPATH=str(ROOT), MLOPS_TPU_FAULTS=str(plan),
               **_image_env(bundle_dir, cache, port, RING_WORKERS, device))
    plane = _PlaneLog(cmd, env, root / "plane.log")
    bodies = _lifecycle_bodies(seed=62)
    statuses: list = []
    result: dict = {}
    try:
        _wait_ready(port, plane.proc, "chaos plane")
        t_armed = plane.wait("lifecycle controller started", 60)
        check(plane.find("fault injection ARMED: 3 rule(s), seed 42") is not None,
              "the plane did not arm the plan")
        # Stall: budgeted requests against stalled dispatches.
        single = bodies[False][1]
        stalls = []
        for _ in range(12):
            burst = _budgeted_burst(port, single, 8)
            stalls.append(burst)
            statuses += [s for s, _ in burst]
            if all(s == 200 for s, _ in burst):
                break
        late = [ms for burst in stalls for s, ms in burst
                if s == 504 and ms > CHAOS_BUDGET_MS + 300]
        check(any(s == 504 for burst in stalls for s, _ in burst),
              f"no 504 from the stalled dispatches: {stalls}")
        check(not late, f"504s past their {CHAOS_BUDGET_MS} ms budget: {late}")
        check(all(s == 200 for s, _ in stalls[-1]), f"still stalling: {stalls}")
        result["stall"] = {"bursts": len(stalls), "504": sum(
            s == 504 for b in stalls for s, _ in b), "max_504_ms": max(
            ms for b in stalls for s, ms in b if s == 504)}
        # Breaker: drifted traffic, two injected retrain failures.
        phase, stop, samples = {"drift": True}, threading.Event(), []
        clients = [threading.Thread(target=_hammer, args=(port, bodies, phase, stop, samples),
                                    daemon=True) for _ in range(2)]
        for client in clients:
            client.start()
        try:
            plane.wait("lifecycle circuit breaker OPEN", 60)
        finally:
            stop.set()
            for client in clients:
                client.join(timeout=60)
        statuses += [s[2] for s in samples]
        check(_scrape_ring(port)["engine_incarnation"] == 1,
              "the engine died before the breaker check")
        deadline = time.monotonic() + 10
        while 'mlops_tpu_lifecycle_breaker_open{tenant="default"} 1' not in _lifecycle_block(
                _http(port, "GET", "/metrics")[1].decode()):
            check(time.monotonic() < deadline, "the breaker gauge never showed on /metrics")
            time.sleep(0.05)
        block = _every_front_end(port, RING_WORKERS)
        check('mlops_tpu_lifecycle_breaker_open{tenant="default"} 1' in block
              and 'mlops_tpu_lifecycle_breaker_trips_total{tenant="default"} 1' in block
              and 'mlops_tpu_drift_trigger_total{tenant="default"} 2' in block,
              f"the breaker on the front ends: {block}")
        check(plane.find("; shadowing") is None, "a retrain ran with the breaker open")
        result["breaker"] = {"requests": len(samples), "front_end_block": block,
                             "open_s": time.monotonic() - t_armed}
        # Engine death at a main-loop tick, then the respawn; the torn
        # writes and the bad cache bytes run in subprocesses meanwhile.
        probe = bodies[False][:CHAOS_BITWISE_REQUESTS]
        before_kill = _sequential(port, probe)
        counters = _counters(port)
        check(_scrape_ring(port)["engine_incarnation"] == 1,
              "the engine died before the pre-kill answers")
        result["torn_writes"] = _torn_writes(root, device)
        result["bad_cache_bytes"] = _bad_cache_bytes(root, device)
        t_kill = plane.wait("fault injected: SIGKILL at serve.engine.exit", 120)
        while True:
            try:
                if (_scrape_ring(port)["engine_incarnation"] == 2
                        and _http(port, "GET", "/healthz/ready")[0] == 200
                        and _lifecycle_scrape(port)["generation"] == 1):
                    break
            except OSError:
                pass
            check(time.monotonic() - t_kill < 120, "the engine never came back after its kill")
            time.sleep(0.05)
        respawn_s = time.monotonic() - t_kill
        after_kill = _sequential(port, probe)
        statuses += [s for s, _ in before_kill + after_kill]
        diff = [i for i, (a, b) in enumerate(zip(before_kill, after_kill)) if a != b]
        check(not diff, f"the respawned engine's answers differ at {diff}")
        later = _counters(port)
        back = {k: (v, later.get(k)) for k, v in counters.items()
                if later.get(k) is None or later[k] < v}
        check(not back, f"counters went back across the engine's death: {back}")
        check(later['mlops_tpu_lifecycle_breaker_trips_total{tenant="default"}'] == 1,
              "the breaker trips were not carried across the respawn")
        result["engine_exit"] = {"tick": CHAOS_EXIT_TICKS, "kill_to_ready_s": respawn_s,
                                 "bitwise_equal_requests": len(probe),
                                 "counters_checked": len(counters)}
        rc = plane.stop()
    finally:
        if plane.proc.poll() is None:
            plane.proc.kill()
            plane.proc.wait(timeout=30)
    pids, _, text = _ring_log(plane.path)
    check(rc == 0, f"the chaos plane exited {rc} after SIGTERM")
    for worker in range(RING_WORKERS):
        check(f"frontend {worker} (pid {pids[f'frontend {worker}']}) exited 0" in text,
              f"front end {worker} did not exit 0")
    check(f"engine replica 0 (pid {pids['engine']}) exited 0" in text, "the engine did not exit 0")
    check(text.count("injected retrain failure") >= 2, "the retrain failures were not logged")
    outside = sorted({s for s in statuses if s not in CHAOS_ALLOWED}, key=str)
    check(not outside, f"statuses outside {sorted(CHAOS_ALLOWED)}: {outside}")
    result["statuses"] = {str(s): statuses.count(s) for s in sorted(set(statuses), key=str)}
    log_timing("chaos", result)
    return result


# ----------------------------------------------------------------- phase 33
# The engine replica set as the serving image starts it: `serve --workers W
# --replicas 2` (and `--replicas 1` beside it, in the same call) on phase
# 22's bundle with the image's environment and a warmed kernel cache.
REPLICA_CONCURRENCY = (16, 64)
REPLICA_BITWISE_REQUESTS = 64  # one at a time, before the kill and after it


def _replica_workers() -> int:
    """Front ends of phases 33-34: four where the machine has eight cores,
    else two."""
    return 4 if (os.cpu_count() or 1) >= 8 else 2


def _series(port: int) -> dict[str, float]:
    """Every sample of a /metrics scrape, by its series and labels."""
    _, text = _http(port, "GET", "/metrics")
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.decode().splitlines() if line and not line.startswith("#")}


def _replica(series: dict, name: str, r: int) -> float:
    return series[f'mlops_tpu_replica_{name}{{replica="{r}"}}']


def _wait_replicas(port: int, proc, replicas: int, what: str, incarnations=None,
                   timeout: float = 300) -> dict:
    """Until every replica is ready (at ``incarnations`` when given)."""
    deadline = time.monotonic() + timeout
    while True:
        check(proc.poll() is None, f"{what} exited early ({proc.returncode})")
        try:
            series = _series(port)
            if all(_replica(series, "ready", r) == 1 and (
                    incarnations is None or _replica(series, "incarnation", r)
                    >= incarnations[r]) for r in range(replicas)):
                return series
        except (OSError, KeyError):
            pass
        check(time.monotonic() < deadline, f"{what}: the replicas never became ready")
        time.sleep(0.05)


def _plane_procs(log_path: Path) -> dict[str, int]:
    """The plane's front ends and replicas by name (``engine`` aliases
    replica 0), for the CPU shares."""
    pids, _, _ = _ring_log(log_path)
    return {name: pid for name, pid in pids.items() if name != "engine"}


def phase_replicas(bundle_dir: Path, device: str = "cuda") -> dict:
    """Phase 33: ``serve --workers W --replicas 2`` and ``--replicas 1``
    side by side with the serving image's environment on a warmed cache
    (W = 4 with eight cores, else 2). Replica 0 starts, then replica 1
    with no nvcc; both and only the replica processes hold the card.
    Phase 29's bursts at 16 and 64 connections on each plane in turns:
    every answer against the CPU route, requests/s, p50/p99, dispatches
    per request, the CPU cores each front end and replica kept busy, each
    replica's rows, ``quant_fused`` launches equal to the quant-tier
    dispatches summed over the replicas. kill -9 of replica 1 under 64
    connections: every answer 200 and right, replica 0's incarnation
    unchanged, replica 1's up by one, every per-replica counter monotone;
    then replica 0 killed at rest and 64 requests one at a time through
    the respawned replica 1, bitwise as before the kills. SIGTERM: every
    child exits 0. ``--replicas 2 lifecycle.enabled=true`` exits with the
    JAX package's message."""
    import numpy as np

    root = WORK / "replicas"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache = WORK / "ring" / "cache"
    _warm_cache(bundle_dir, cache, device)
    workers, cores = _replica_workers(), os.cpu_count()
    log(f"replica set: {workers} front ends on {cores} cores")
    bursts = _ring_bursts(bundle_dir)
    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    planes = {}
    for replicas in (2, 1):
        port = _free_port()
        log_path = root / f"plane_e{replicas}.log"
        out = open(log_path, "wb")
        planes[replicas] = (port, out, subprocess.Popen(
            _cli(["serve", "--workers", str(workers), "--replicas", str(replicas)]),
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            env={**base_env, **_image_env(bundle_dir, cache, port, workers, device)}),
            log_path)
    rows = []
    try:
        for replicas, (port, _, proc, _) in planes.items():
            _wait_ready(port, proc, f"replica plane E={replicas}")
            _wait_replicas(port, proc, replicas, f"replica plane E={replicas}")
        port, _, proc, log_path = planes[2]
        pids, ready, text = _ring_log(log_path)
        check(sorted(r["replica"] for r in ready) == [0, 1], f"the replicas' starts: {ready}")
        if device == "cuda":
            check(all(r["nvcc_calls"] == 0 for r in ready),
                  f"a replica built a kernel on the warmed cache: {ready}")
        check(text.count("tiers=quant,exact") == 2, "a replica does not hold both tiers")
        members = {proc.pid, *_children(proc.pid)}
        holders = sorted(pid for pid in members if _holds_card(pid))
        replica_pids = sorted((pids["engine 0"], pids["engine 1"]))
        if device == "cuda":
            check(holders == replica_pids,
                  f"processes holding the card {holders}, replicas {replica_pids}")
        start = {"holding_the_card": holders, "replica_pids": replica_pids,
                 "ready": [{k: r[k] for k in ("replica", "ready_s", "nvcc_calls")}
                           for r in ready]}
        log(f"replica plane: {json.dumps(start)}")
        single = bursts[0]
        probe = _sub_burst(single, list(range(REPLICA_BITWISE_REQUESTS)))
        settled = _scrape(port)
        probe_before, _, _ = _run_burst(port, probe, 1)
        _check_burst(probe, probe_before, "replica probe")
        _await_rows(port, settled, len(probe["bodies"]), "replica probe")  # single records
        for burst in bursts:
            for concurrency in REPLICA_CONCURRENCY:
                for replicas in (2, 1):
                    port, _, _, log_path = planes[replicas]
                    procs = {"client": os.getpid(), **_plane_procs(log_path)}
                    before, series0 = _scrape(port), _series(port)
                    cpu0 = {name: _cpu_s(pid) for name, pid in procs.items()}
                    out, lat, wall = _run_burst(port, burst, concurrency)
                    cpu = {name: round((_cpu_s(pid) - cpu0[name]) / wall, 3)
                           for name, pid in procs.items()}
                    what = f"replicas {burst['kind']} c={concurrency} E={replicas}"
                    worst = _check_burst(burst, out, what)
                    after = _await_rows(port, before, burst["rows"], what)
                    series1 = _series(port)
                    d = {k: after[k] - before[k] for k in before}
                    expected = d["quant_dispatches"] if device == "cuda" else 0
                    check(d["launches"] == expected,
                          f"{what}: {d['launches']} quant_fused launches for "
                          f"{d['quant_dispatches']} quant-tier dispatches")
                    row = {
                        "kind": burst["kind"], "concurrency": concurrency,
                        "replicas": replicas, "workers": workers,
                        "requests": len(burst["bodies"]), "records": burst["rows"],
                        "requests_per_s": len(burst["bodies"]) / wall,
                        "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "dispatches_per_request": d["dispatches"] / len(burst["bodies"]),
                        "quant_fused_launches": d["launches"],
                        "replica_rows": [_replica(series1, "rows_scored_total", r)
                                         - _replica(series0, "rows_scored_total", r)
                                         for r in range(replicas)],
                        "max_pred_err": worst["pred"], "max_drift_err": worst["drift"],
                        "cpu_share": cpu,
                    }
                    log_timing("replica burst", row)
                    rows.append(row)
        # kill -9 of replica 1 while 64 connections stream requests.
        port, _, proc, log_path = planes[2]
        pids, ready, _ = _ring_log(log_path)
        before = _series(port)
        result = {}
        thread = threading.Thread(target=lambda: result.setdefault(
            "out", _run_burst(port, single, 64)[0]))
        thread.start()
        time.sleep(0.3)
        os.kill(pids["engine 1"], signal.SIGKILL)
        t_kill = time.monotonic()
        inc = [int(_replica(before, "incarnation", r)) for r in (0, 1)]
        after = _wait_replicas(port, proc, 2, "replica 1's respawn", [inc[0], inc[1] + 1])
        kill_to_ready = time.monotonic() - t_kill
        thread.join(timeout=300)
        worst = _check_burst(single, result["out"], "replica 1 kill -9 stream")
        after = _series(port)
        check(_replica(after, "incarnation", 0) == inc[0],
              "replica 0's incarnation moved when replica 1 died")
        check(_replica(after, "incarnation", 1) == inc[1] + 1,
              "replica 1's incarnation did not move up by one")
        check(_replica(after, "respawn_total", 1) == _replica(before, "respawn_total", 1) + 1,
              "replica 1's respawn was not counted")
        back = [name for name, value in before.items()
                if (name.startswith("mlops_tpu_replica_") and "_total{" in name)
                and after[name] < value]
        check(not back, f"per-replica counters went back across the kill: {back}")
        _, ready_after, _ = _ring_log(log_path)
        new = [r for r in ready_after if r["replica"] == 1][-1]
        if device == "cuda":
            check(new["nvcc_calls"] == 0, f"the respawned replica built a kernel: {new}")
        kill = {"kill_to_ready_s": kill_to_ready, "replica_ready_s": new["ready_s"],
                "nvcc_calls": new["nvcc_calls"], "stream_requests": len(single["bodies"]),
                "replayed_slots": _replica(after, "replayed_slots_total", 1)
                - _replica(before, "replayed_slots_total", 1),
                "max_pred_err": worst["pred"],
                "replica_incarnations": [_replica(after, "incarnation", r) for r in (0, 1)]}
        # Replica 0 killed at rest: the probe goes through the respawned
        # replica 1 (the router routes around the dead one) and answers
        # bitwise as the plane did before the kills.
        pids, _, _ = _ring_log(log_path)
        rows1 = _replica(_series(port), "rows_scored_total", 1)
        os.kill(pids["engine 0"], signal.SIGKILL)
        deadline = time.monotonic() + 30
        while _replica(_series(port), "ready", 0) == 1:
            check(time.monotonic() < deadline, "replica 0's death was not seen")
            time.sleep(0.01)
        probe_after, _, _ = _run_burst(port, probe, 1)
        diff = [i for i, (a, b) in enumerate(zip(probe_before, probe_after)) if a != b]
        check(not diff, f"the respawned replica 1 answers differently at {diff[:10]}")
        series = _wait_replicas(port, proc, 2, "replica 0's respawn", [inc[0] + 1, inc[1] + 1])
        kill["bitwise_equal_requests"] = len(probe["bodies"])
        kill["probe_rows_on_replica_1"] = _replica(series, "rows_scored_total", 1) - rows1
        log_timing("replica kill -9", kill)
        # SIGTERM: both planes drain, every child exits 0.
        for replicas, (port, _, proc, log_path) in planes.items():
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=180) == 0, f"replica plane E={replicas} did not exit 0")
            pids, _, text = _ring_log(log_path)
            for w in range(workers):
                check(f"frontend {w} (pid {pids[f'frontend {w}']}) exited 0" in text,
                      f"E={replicas}: front end {w} did not exit 0")
            for r in range(replicas):
                check(f"engine replica {r} (pid {pids[f'engine {r}']}) exited 0" in text,
                      f"E={replicas}: replica {r} did not exit 0")
    finally:
        for _, out, proc, _ in planes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    refused = subprocess.run(
        _cli(["serve", "--workers", "2", "--replicas", "2", "lifecycle.enabled=true"]),
        cwd=ROOT, env={**base_env, **_image_env(bundle_dir, cache, _free_port(), 2, device)},
        capture_output=True, text=True, timeout=300)
    check(refused.returncode != 0 and "serve.engine_replicas > 1 is incompatible with "
          "lifecycle.enabled" in refused.stderr,
          f"--replicas 2 with the loop: {refused.returncode} {refused.stderr[-1500:]}")
    result = {"workers": workers, "cores": cores, "start": start, "bursts": rows,
              "kill": kill, "lifecycle_refusal": refused.stderr.strip().splitlines()[-1],
              "launches": sum(r["quant_fused_launches"] for r in rows if r["replicas"] == 2)}
    log_timing("replica set", {k: result[k] for k in ("workers", "cores", "kill", "launches")})
    return result


# ----------------------------------------------------------------- phase 34
# The tenant fleet of configs/tenants.toml: its names, order, weights and
# default, with only the bundle directories replaced.
TENANT_NAMES = ("emea", "apac", "latam-ab-arm")
TENANT_PROBE_REQUESTS = 32  # per tenant, one at a time, on each plane
TENANT_HOT_CONNECTIONS = 80  # apac: 10x the cold tenants' rate
TENANT_COLD_CONNECTIONS = 8
TENANT_QUOTA_S = 3.0  # cut from 5 s
TENANT_KILL_REQUESTS = 300  # cut from 600
TENANT_RETRAIN_STEPS = 40  # of configs/lifecycle_serve.toml's 300


def phase_tenant_bundles(burst_dir: Path, dirs: dict) -> dict:
    """The fleet's bundles: emea is phase 22's (mlp-ens8 with a gated quant
    student), apac its architecture twin from other seeds, latam-ab-arm
    phase 17's mlp (no quant tier)."""
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student

    emea = load_bundle(burst_dir)
    model = build_model(emea.model_config)
    _seeded_exact_params(model, 7)
    apac = WORK / "tenant_apac"
    shutil.rmtree(apac, ignore_errors=True)
    save_exact_bundle(
        apac, emea.model_config, model, emea.preprocessor, emea.monitor,
        calibration={"temperature": 1.1},
        quant_params=quantize_student(init_quant_master(2)),
        quant={"fidelity": {}, "temperature": 1.0, "gates": {
            "passed": True, "note": "seeded weights, not distilled"}},
        tags={"source": "chip_smoke.py"},
    )
    return dict(zip(TENANT_NAMES, (Path(burst_dir), apac, Path(dirs["mlp"]))))


def _tenants_toml(path: Path, bundles: dict) -> Path:
    """configs/tenants.toml with its three bundle directories replaced."""
    text = (ROOT / "configs" / "tenants.toml").read_text()
    for old, name in zip(("registry/credit-default/3", "registry/credit-default-apac/1",
                          "registry/credit-default-latam/2"), TENANT_NAMES):
        check(f'"{old}"' in text, f"configs/tenants.toml no longer names {old}")
        text = text.replace(f'"{old}"', json.dumps(str(bundles[name])))
    path.write_text(text)
    return path


def _tenant_probe(port: int, bodies: list[bytes], tenant: str | None) -> list:
    """One keep-alive connection, one request at a time, every fourth
    cheap; (status, body) of each."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = []
    try:
        for i, body in enumerate(bodies):
            headers = {"content-type": "application/json"}
            if i % BURST_CHEAP_EVERY == 0:
                headers["x-slo-class"] = "cheap"
            if tenant is not None:
                headers["x-tenant"] = tenant
            conn.request("POST", "/predict", body=body, headers=headers)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
    finally:
        conn.close()
    return out


async def _tenant_client(port: int, tenant: str, body: bytes, stop_at: float,
                         samples: list) -> None:
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = (f"POST /predict HTTP/1.1\r\nhost: localhost\r\nx-tenant: {tenant}\r\n"
            f"content-type: application/json\r\ncontent-length: {len(body)}\r\n\r\n").encode()
    try:
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            writer.write(head + body)
            status = int((await reader.readline()).split()[1])
            length = 0
            while (line := await reader.readline()) not in (b"\r\n", b""):
                name, _, value = line.decode("latin1").partition(":")
                if name.strip().lower() == "content-length":
                    length = int(value)
            payload = await reader.readexactly(length)
            samples.append((tenant, status, (time.perf_counter() - t0) * 1e3, payload))
    finally:
        writer.close()


def _tenant_load(port: int, body: bytes, clients: dict, seconds: float) -> list:
    import asyncio

    samples: list = []
    stop_at = time.monotonic() + seconds

    async def main():
        await asyncio.gather(*(_tenant_client(port, tenant, body, stop_at, samples)
                               for tenant, n in clients.items() for _ in range(n)))

    asyncio.run(main())
    return samples


def phase_tenants(burst_dir: Path, dirs: dict, device: str = "cuda",
                  extra: tuple[str, ...] = ()) -> dict:
    """Phase 34: configs/tenants.toml's fleet (emea, apac, latam-ab-arm;
    weights 2, 1, 1; emea the default), its bundle directories replaced,
    served with tier routing by ``serve --tenants <file>`` and by ``serve
    --tenants <file> --workers W --replicas 2`` side by side. Each
    tenant's answers one at a time are bitwise the same bundle's served
    alone on the card; untagged requests are emea's, an unknown tenant a
    404. On the ring: apac on 10x the cold tenants' connections sheds 503s
    against its own quota (counted per tenant), the cold tenants never
    see a non-200; kill -9 of replica 1 under every tenant's traffic,
    every answer 200 and its own tenant's. Then the loop: ``--config
    configs/lifecycle_serve.toml`` with ``--tenants`` on ``--replicas 1``,
    phase 30's clocks, window and paced clients, drifted traffic to
    latam-ab-arm alone:
    latam-ab-arm promoted to generation 2, emea and apac at 1, each
    tenant's lifecycle block on every front end, 0 non-200."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.schema.validate import validate_records
    from mlops_tpu_torch.serve.engine import InferenceEngine

    root = WORK / "tenants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    bundles = phase_tenant_bundles(burst_dir, dirs)
    toml = _tenants_toml(root / "tenants.toml", bundles)
    cache = WORK / "ring" / "cache"
    _warm_cache(burst_dir, cache, device)
    workers = _replica_workers()
    pool = _records(TENANT_PROBE_REQUESTS * 5, 71, drift=0.3)
    bodies = [json.dumps(pool[5 * k:5 * k + (1 if k % 2 else 5)]).encode()
              for k in range(TENANT_PROBE_REQUESTS)]
    # Each bundle served alone on the card, one request at a time: the
    # bytes every plane must answer.
    want, has_quant = {}, {}
    for name, path in bundles.items():
        engine = InferenceEngine(load_bundle(path), device=device, tier_routing=True)
        engine.warmup()
        has_quant[name] = "quant" in engine.available_tiers
        want[name] = []
        for i, body in enumerate(bodies):
            records, errors = validate_records(body)
            check(not errors, f"probe body {i}: {errors}")
            tier = "quant" if i % BURST_CHEAP_EVERY == 0 and has_quant[name] else None
            want[name].append(engine.predict_records_wire(records, tier=tier))
        del engine
    a, b = (np.asarray([json.loads(w)["predictions"][0] for w in want[n]])
            for n in ("emea", "apac"))
    gap = float(np.abs(a - b).max())
    # The kill check below tells the twins apart only if they differ by
    # more than twice its tolerance somewhere.
    check(gap > 2 * (EXACT_PRED_ATOL + 1e-6), f"emea and apac answer alike ({gap:.3g})")
    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    planes = {}
    for mode, args, w in (("single", [], 0),
                          ("ring", ["--workers", str(workers), "--replicas", "2"], workers)):
        port = _free_port()
        log_path = root / f"plane_{mode}.log"
        out = open(log_path, "wb")
        planes[mode] = (port, out, subprocess.Popen(
            _cli(["serve", "--tenants", str(toml), *args]), cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT,
            env={**base_env, **_image_env(burst_dir, cache, port, w, device)}), log_path)
    result: dict = {"workers": workers, "tenants": list(TENANT_NAMES),
                    "max_gap_emea_apac": gap}
    try:
        for mode, (port, _, proc, _) in planes.items():
            _wait_ready(port, proc, f"tenant plane {mode}")
        port, _, proc, log_path = planes["ring"]
        _wait_replicas(port, proc, 2, "tenant ring plane")
        pids, ready, text = _ring_log(log_path)
        check(sorted(r["replica"] for r in ready) == [0, 1]
              and all(r["tenants"] == list(TENANT_NAMES) for r in ready),
              f"the tenant replicas' starts: {ready}")
        holders = sorted(pid for pid in {proc.pid, *_children(proc.pid)} if _holds_card(pid))
        if device == "cuda":
            check(holders == sorted((pids["engine 0"], pids["engine 1"])),
                  f"tenant plane: processes holding the card {holders}")
        result["ready"] = [{k: r[k] for k in ("replica", "ready_s", "nvcc_calls")}
                           for r in ready]
        result["graph_pool_bytes"] = {
            name: row.get("graph_pool_bytes") for name, row in ready[0]["warmup"].items()
            if isinstance(row, dict)}
        for mode, (port, _, proc, _) in planes.items():
            launches0 = _scrape(port)["launches"]
            for name in TENANT_NAMES:
                got = _tenant_probe(port, bodies, name)
                diff = [i for i, ((status, body), w) in enumerate(zip(got, want[name]))
                        if status != 200 or body != w]
                check(not diff, f"tenant plane {mode}: {name}'s answers differ from the "
                      f"bundle's alone at {diff[:10]}")
            untagged = _tenant_probe(port, bodies[:8], None)
            check([b for _, b in untagged] == want["emea"][:8],
                  f"tenant plane {mode}: untagged requests are not emea's")
            status, payload = _tenant_probe(port, bodies[:1], "nope")[0]
            check(status == 404 and json.loads(payload) == {
                "detail": "unknown tenant 'nope'"}, f"tenant plane {mode}: {status} {payload}")
            quant = sum(1 for i in range(TENANT_PROBE_REQUESTS) if i % BURST_CHEAP_EVERY == 0
                        ) * sum(has_quant.values()) + 2 * has_quant["emea"]
            time.sleep(0.1)
            launched = _scrape(port)["launches"] - launches0
            if device == "cuda":
                check(launched == quant, f"tenant plane {mode}: {launched} quant_fused "
                      f"launches for {quant} quant-tier requests")
            result[f"{mode}_probe_launches"] = launched
        port, _, proc, _ = planes["single"]
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=120) == 0, "the single-process tenant plane did not exit 0")
        # Quota: apac on 10x the connections.
        port, _, proc, log_path = planes["ring"]
        series0 = _series(port)
        launches0 = _scrape(port)["launches"]
        samples = _tenant_load(port, bodies[1], {
            "apac": TENANT_HOT_CONNECTIONS, "emea": TENANT_COLD_CONNECTIONS,
            "latam-ab-arm": TENANT_COLD_CONNECTIONS}, TENANT_QUOTA_S)
        series1 = _series(port)
        quota = {}
        for name in TENANT_NAMES:
            mine = [s for s in samples if s[0] == name]
            lat = [s[2] for s in mine]
            shed = [s for s in mine if s[1] == 503]
            quota[name] = {
                "requests": len(mine), "requests_per_s": len(mine) / TENANT_QUOTA_S,
                "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                "ok": sum(s[1] == 200 for s in mine), "quota_503": len(shed),
                "quota_shed_counted": sum(
                    series1[f'mlops_tpu_tenant_quota_shed_total{{worker="{w}",tenant="{name}"}}']
                    - series0[f'mlops_tpu_tenant_quota_shed_total{{worker="{w}",tenant="{name}"}}']
                    for w in range(workers)),
            }
            other = {s[1] for s in mine} - {200, 503}
            check(not other, f"tenant {name} answered {other} under the quota load")
            body = json.dumps({"detail": f"tenant {name!r} over quota; retry in 1s"},
                              separators=(",", ":")).encode()
            check(all(s[3] == body for s in shed), f"tenant {name}: a 503 not of its quota")
            check(quota[name]["quota_shed_counted"] == len(shed),
                  f"tenant {name}: {len(shed)} quota 503s, {quota[name]['quota_shed_counted']}"
                  " counted")
        check(quota["apac"]["quota_503"] > 0, f"apac at 10x never shed: {quota['apac']}")
        for name in ("emea", "latam-ab-arm"):
            check(quota[name]["ok"] == quota[name]["requests"] > 0,
                  f"cold tenant {name} saw a non-200: {quota[name]}")
        result["quota"] = quota
        result["quota_launches"] = _scrape(port)["launches"] - launches0
        log_timing("tenant quota", quota)
        # kill -9 of replica 1 under every tenant's traffic.
        inc = [int(_replica(series1, "incarnation", r)) for r in (0, 1)]
        work = [(name, i) for i in range(TENANT_KILL_REQUESTS // 3) for name in TENANT_NAMES]
        outs: list = [None] * len(work)
        order = iter(range(len(work)))
        lock = threading.Lock()

        def stream():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            while True:
                with lock:
                    k = next(order, None)
                if k is None:
                    break
                name, i = work[k]
                j = 1 + 2 * (i % (TENANT_PROBE_REQUESTS // 2))  # single records, exact
                conn.request("POST", "/predict", body=bodies[j],
                             headers={"content-type": "application/json", "x-tenant": name})
                resp = conn.getresponse()
                outs[k] = (resp.status, resp.read(), j)
            conn.close()

        streams = [threading.Thread(target=stream) for _ in range(12)]
        for t in streams:
            t.start()
        time.sleep(0.3)
        os.kill(pids["engine 1"], signal.SIGKILL)
        t_kill = time.monotonic()
        _wait_replicas(port, proc, 2, "tenant replica 1's respawn", [inc[0], inc[1] + 1])
        kill_to_ready = time.monotonic() - t_kill
        for t in streams:
            t.join(timeout=300)
        worst = 0.0
        for (name, _), out in zip(work, outs):
            check(out is not None and out[0] == 200, f"tenant kill -9: {name} got {out}")
            got = np.asarray(json.loads(out[1])["predictions"])
            ref = np.asarray(json.loads(want[name][out[2]])["predictions"])
            err = float(np.abs(got - ref).max())
            check(err <= EXACT_PRED_ATOL + 1e-6, f"tenant kill -9: a {name} answer is "
                  f"{err:.3g} from its bundle's")
            worst = max(worst, err)
        series2 = _series(port)
        check(_replica(series2, "incarnation", 0) == inc[0], "replica 0's incarnation moved")
        result["kill"] = {"kill_to_ready_s": kill_to_ready, "requests": len(work),
                          "max_pred_err": worst,
                          "replayed_slots": _replica(series2, "replayed_slots_total", 1)
                          - _replica(series1, "replayed_slots_total", 1)}
        log_timing("tenant kill -9", result["kill"])
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=180) == 0, "the tenant ring plane did not exit 0")
    finally:
        for _, out, proc, _ in planes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    result["loop"] = _tenant_loop(toml, burst_dir, cache, workers, device, extra)
    log_timing("tenant fleet", {k: v for k, v in result.items() if k != "quota"})
    return result


def _tenant_loop(toml: Path, burst_dir: Path, cache: Path, workers: int, device: str,
                 extra: tuple[str, ...]) -> dict:
    """The per-tenant loops on the ring (one replica): drifted traffic to
    latam-ab-arm alone promotes it alone."""
    from mlops_tpu_torch.data.ingest import write_csv_columns

    root = WORK / "tenants" / "loop"
    root.mkdir(parents=True, exist_ok=True)
    window = WORK / "lifecycle_window.csv"
    if not window.is_file():
        write_csv_columns(window, *_drifted_columns(LIFECYCLE_WINDOW_ROWS, seed=3))
    port = _free_port()
    cmd = _cli(["serve", "--config", LIFECYCLE_TOML, "--tenants", str(toml),
                "--workers", str(workers), "--replicas", "1",
                f"lifecycle.dir={root / 'state'}", f"lifecycle.labeled_path={window}",
                *LIFECYCLE_CLOCKS, f"lifecycle.retrain_steps={TENANT_RETRAIN_STEPS}", *extra])
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               **_image_env(burst_dir, cache, port, workers, device))
    plane = _PlaneLog(cmd, env, root / "plane.log")
    bodies = _lifecycle_bodies(seed=81)
    phases = {name: {"drift": False} for name in TENANT_NAMES}
    stop = threading.Event()
    samples: list = []
    try:
        _wait_ready(port, plane.proc, "tenant loop plane")
        plane.wait("lifecycle controller started", 60)
        clients = [threading.Thread(target=_hammer, daemon=True, args=(
            port, bodies, phases[name], stop, samples),
            kwargs={"tenant": name, "pause_s": LIFECYCLE_SERVER_PAUSE_S})
            for name in ("latam-ab-arm", "latam-ab-arm", "emea", "apac")]
        for client in clients:
            client.start()
        time.sleep(2.0)
        phases["latam-ab-arm"]["drift"] = True
        t0 = time.monotonic()
        t_trigger = plane.wait("lifecycle trigger fired", 120)
        t_swap = plane.wait("candidate promoted: generation", 300, after=t_trigger)
        time.sleep(1.0)
        stop.set()
        for client in clients:
            client.join(timeout=120)
        # The controllers fold the last requests' rows into their
        # reservoirs on their next ticks: compare the front ends' blocks
        # once two reads a second apart agree.
        settled, deadline = None, time.monotonic() + 30
        while True:
            block = _lifecycle_block(_http(port, "GET", "/metrics")[1].decode(), TENANT_NAMES)
            if block == settled or time.monotonic() > deadline:
                break
            settled = block
            time.sleep(1.0)
        block = _every_front_end(port, workers, TENANT_NAMES)
        for name, generation in (("emea", 1), ("apac", 1), ("latam-ab-arm", 2)):
            check(f'mlops_tpu_bundle_generation{{tenant="{name}"}} {generation}' in block,
                  f"tenant loop: {name} not at generation {generation}: {block}")
        for name in ("emea", "apac"):
            check(f'mlops_tpu_drift_trigger_total{{tenant="{name}"}} 0' in block,
                  f"tenant loop: a trigger fired for {name}, which saw no drift: {block}")
        launches = _scrape(port)["launches"]
        rc = plane.stop()
    finally:
        stop.set()
        if plane.proc.poll() is None:
            plane.proc.kill()
            plane.proc.wait(timeout=30)
    check(rc == 0, f"the tenant loop plane exited {rc}")
    bad = [s for s in samples if s[2] != 200]
    check(not bad, f"tenant loop: {len(bad)} non-200 answers, first {bad[:3]}")
    built = plane.find("; shadowing")[1]
    return {"requests": len(samples), "trigger_s": t_trigger - t0,
            "trigger_to_swap_s": t_swap - t_trigger, "retrain_steps": TENANT_RETRAIN_STEPS,
            "candidate": built.strip(), "promotion": plane.find("candidate promoted")[1].strip(),
            "front_end_block": block, "quant_fused_launches": launches}


# ----------------------------------------------------------------- phase 35
OBS_REQUESTS = 300  # single-record requests of phase 29's burst, per burst
OBS_CONCURRENCY = (16, 64)
OBS_TURNS = 1  # armed and disarmed take turns, this many times each
OBS_FAULT_FIRES = 12  # grouped dispatches that raise in each replica process
OBS_FAULT_REQUESTS = 400  # the burst's last requests, at 16 connections, under the plan
OBS_PROFILE_REQUESTS = 200
OBS_RESPAWN_REQUESTS = 16  # one at a time through the respawned replica 0
OBS_PLAN = f"""\
seed = 35
[[fault]]
point = "serve.engine.dispatch_group"
mode = "raise"
max_fires = {OBS_FAULT_FIRES}
"""


def _loop_lags(port: int) -> dict[int, float]:
    """Each front end's ``mlops_tpu_event_loop_lag_ms`` from one scrape;
    fails unless every one of the plane's workers has its series."""
    text = _http(port, "GET", "/metrics")[1].decode()
    lags = {}
    for line in text.splitlines():
        if line.startswith('mlops_tpu_event_loop_lag_ms{worker="'):
            lags[int(line.split('"')[1])] = float(line.rsplit(" ", 1)[1])
    check(sorted(lags) == list(range(RING_WORKERS)), f"loop-lag series {lags}")
    return lags


def _obs_env(root: Path) -> dict:
    """The observability layer armed through the environment layer, with
    short SLO windows (2 / 5 / 8 / 12 s) so a burst can page, the flight
    recorder dumping on the alert, and the phase's fault plan."""
    return {
        "MLOPS_TPU_TRACE_ENABLED": "true", "MLOPS_TPU_TRACE_DIR": str(root / "traces"),
        "MLOPS_TPU_SLO_ENABLED": "true", "MLOPS_TPU_SLO_LEDGER_DIR": str(root / "ledger"),
        "MLOPS_TPU_SLO_LEDGER_FLUSH_S": "0.5", "MLOPS_TPU_SLO_FLIGHTREC_DIR": str(root / "runs"),
        # The alert is this phase's trigger: the 5xx-spike trigger would
        # dump first and hold the 30 s cooldown.
        "MLOPS_TPU_SLO_FLIGHTREC_SPIKE_ERRORS": "1000000",
        "MLOPS_TPU_SLO_TICK_S": "0.25", "MLOPS_TPU_SLO_FAST_SHORT_S": "2",
        "MLOPS_TPU_SLO_FAST_LONG_S": "5", "MLOPS_TPU_SLO_SLOW_SHORT_S": "8",
        "MLOPS_TPU_SLO_SLOW_LONG_S": "12", "MLOPS_TPU_SERVE_PROFILE_DIR": str(root / "profile"),
        "MLOPS_TPU_FAULTS": str(root / "plan.toml"),
    }


def _statuses(port: int, burst: dict, concurrency: int) -> list[int]:
    out, _, _ = _run_burst(port, burst, concurrency)
    return [status for status, _ in out]


def _entry_dispatches(port: int) -> int:
    _, text = _http(port, "GET", "/metrics")
    return int(sum(float(line.rsplit(" ", 1)[1]) for line in text.decode().splitlines()
                   if line.startswith("mlops_tpu_entry_dispatch_total{")))


def _trace_report(root: Path, *args: str) -> dict:
    out = subprocess.run(_cli(["trace-report", f"trace.dir={root / 'traces'}",
                               f"slo.ledger_dir={root / 'ledger'}", *args]),
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"trace-report {args}: {out.returncode} {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def _stage_table(report: dict) -> dict:
    """entry -> stage -> [p50, p99] ms, and wall p50 / p99."""
    return {g["entry"]: {"requests": g["requests"], "wall": [g["wall_p50_ms"], g["wall_p99_ms"]],
                         **{s: [v["p50_ms"], v["p99_ms"]] for s, v in g["stages"].items()}}
            for g in report["groups"]}


def _profile_counts(profile_dir: Path) -> dict:
    """Kernel and graph-launch events in the newest trace file."""
    traces = sorted(profile_dir.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    check(bool(traces), f"no trace file in {profile_dir}")
    events = json.loads(traces[-1].read_text()).get("traceEvents", [])
    names = [e.get("name", "") for e in events]
    return {"file": traces[-1].name, "events": len(events),
            "quant_fused_kernel": sum("quant_fused_kernel" in n for n in names),
            "graph_launches": sum(n == "cudaGraphLaunch" for n in names),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events)}


def phase_observability(bundle_dir: Path, device: str = "cuda") -> dict:
    """Phase 35: the observability layer on the ring plane as the serving
    image starts it, with ``--replicas 2`` on phase 22's bundle and phase
    29's warmed cache: tracing, the SLO engine, the cost ledger, the
    flight recorder and ``serve.profile_dir`` armed through the
    ``MLOPS_TPU_*`` layer (short SLO windows), beside the same plane
    disarmed. (d) A seeded fault plan (the first grouped dispatches of each
    replica raise) pages: ``mlops_tpu_alert_active`` 1, ``/healthz``
    degraded, a flight-recorder dump that ``flightrec`` renders. (a) Phase
    29's single-record burst at 16 and 64 connections, every answer
    against the CPU route, ``trace-report`` per entry and per replica, the
    spans stitched and dropped; (b) the same bursts on the disarmed plane
    in turns, requests/s side by side. (c) ``/debug/profile`` start / stop
    through a front end: the trace file and its ``quant_fused`` kernel or
    graph-launch events. (e) kill -9 of replica 0 at rest: the cost
    ledger's counts carried by the respawn, then ``trace-report
    --ledger``. (f) In this process: a quant bucket and a group geometry
    without their graphs and their captures failing at
    ``serve.engine.compile`` are served through the next larger graphs,
    bitwise the warmed answers, counted in
    ``mlops_tpu_degraded_dispatch_total``. SIGTERM: every child exits 0."""
    import numpy as np

    root = WORK / "observability"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    (root / "plan.toml").write_text(OBS_PLAN)
    cache = WORK / "ring" / "cache"
    _warm_cache(bundle_dir, cache, device)
    single = _ring_bursts(bundle_dir)[0]
    burst = _sub_burst(single, list(range(OBS_REQUESTS)))
    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    planes = {}
    for name in ("armed", "disarmed"):
        port = _free_port()
        log_path = root / f"plane_{name}.log"
        out = open(log_path, "wb")
        env = {**base_env, **_image_env(bundle_dir, cache, port, RING_WORKERS, device),
               **(_obs_env(root) | {"MLOPS_TPU_SERVE_LOOP_LAG_MONITOR": "true"}
                  if name == "armed" else {})}
        planes[name] = (port, out, subprocess.Popen(
            _cli(["serve", "--workers", str(RING_WORKERS), "--replicas", "2"]),
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, env=env), log_path)
    result: dict = {}
    try:
        for name, (port, _, proc, _) in planes.items():
            _wait_ready(port, proc, f"{name} plane")
            _wait_replicas(port, proc, 2, f"{name} plane")
        port, _, proc, log_path = planes["armed"]
        text = log_path.read_text(errors="replace")
        check("fault injection ARMED" in text and "SLO engine armed" in text
              and text.count("cost ledger armed") == 2
              and text.count("loop-lag sanitizer armed") == RING_WORKERS,
              "the armed plane's log")
        # (d) the fault plan pages.
        t0 = time.monotonic()
        n = len(single["bodies"])
        fault = _sub_burst(single, list(range(n - OBS_FAULT_REQUESTS, n)))
        statuses = _statuses(port, fault, 16)
        bad = sum(s == 500 for s in statuses)
        check(bad > 0 and set(statuses) <= {200, 500}, f"fault burst statuses {set(statuses)}")
        page = ('mlops_tpu_alert_active{alert="availability_fast_burn",severity="page",'
                'tenant="default"}')
        while _metric(_http(port, "GET", "/metrics")[1].decode(), page) != 1:
            check(time.monotonic() - t0 < 30, "the fast-burn alert never fired")
            time.sleep(0.05)
        page_s = time.monotonic() - t0
        status, body = _http(port, "GET", "/healthz")
        verdict = json.loads(body)
        check(status == 200 and verdict["verdict"] == "degraded"
              and any(a["alert"] == "availability_fast_burn" for a in verdict["alerts"]),
              f"/healthz under the burn: {status} {verdict}")
        while not (dumps := sorted((root / "runs").glob("flightrec-*.json"))):
            check(time.monotonic() - t0 < 30, "no flight-recorder dump")
            time.sleep(0.05)
        rendered = subprocess.run(_cli(["flightrec", *map(str, dumps)]), cwd=ROOT,
                                  env=base_env, capture_output=True, text=True, timeout=120)
        check(rendered.returncode == 0, f"flightrec: {rendered.stderr[-2000:]}")
        summary = json.loads(rendered.stdout)
        check(any(d["reason"] == "alert-availability_fast_burn" for d in summary),
              f"flightrec dumps: {summary}")
        for _ in range(10):
            # The plan's fires run out in both replicas (each logs its
            # injections; a clean burst alone may have missed one replica's
            # grouped dispatches), then a clean pass.
            spent = (log_path.read_text(errors="replace").count("fault injected: raise")
                     >= 2 * OBS_FAULT_FIRES)
            if set(_statuses(port, _sub_burst(single, list(range(200))), 16)) == {200} and spent:
                break
        else:
            raise SmokeFailure("the fault plan's grouped dispatches never stopped raising")
        result["fault"] = {"requests": len(statuses), "answered_500": bad,
                           "fast_burn_after_s": page_s, "verdict": verdict["verdict"],
                           "alerts": [a["alert"] for a in verdict["alerts"]],
                           "dumps": [{k: d[k] for k in ("reason", "worker", "events")}
                                     for d in summary],
                           "timeline_lines": rendered.stderr.count("\n")}
        log_timing("observability fault", result["fault"])
        # (a) + (b): the bursts, armed and disarmed in turns.
        rows = []
        launches = quant = 0.0
        lags = {name: {w: [] for w in range(RING_WORKERS)} for name in planes}
        for turn in range(OBS_TURNS):
            for concurrency in OBS_CONCURRENCY:
                for name in ("armed", "disarmed"):
                    port = planes[name][0]
                    before = _scrape(port)
                    out, lat, wall = _run_burst(port, burst, concurrency)
                    worst = _check_burst(burst, out, f"observability {name} c={concurrency}")
                    # Dispatches and launches are mirrored at dispatch time:
                    # no wait for the monitor's cadence.
                    after = _scrape(port)
                    d = {k: after[k] - before[k] for k in before}
                    if device == "cuda":
                        check(d["launches"] == d["quant_dispatches"],
                              f"{name}: {d['launches']} quant_fused launches for "
                              f"{d['quant_dispatches']} quant-tier dispatches")
                    if name == "armed":
                        launches += d["launches"]
                        quant += d["quant_dispatches"]
                    lag = _loop_lags(port)
                    for w in range(RING_WORKERS):
                        lags[name][w].append(lag[w])
                    row = {"plane": name, "turn": turn, "concurrency": concurrency,
                           "requests_per_s": len(burst["bodies"]) / wall,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99)),
                           "dispatches_per_request": d["dispatches"] / len(burst["bodies"]),
                           "max_pred_err": worst["pred"]}
                    log_timing("observability burst", row)
                    rows.append(row)
        result["bursts"] = rows
        ratio = {}
        for c in OBS_CONCURRENCY:
            armed = [r["requests_per_s"] for r in rows if r["plane"] == "armed"
                     and r["concurrency"] == c]
            disarmed = [r["requests_per_s"] for r in rows if r["plane"] == "disarmed"
                        and r["concurrency"] == c]
            ratio[c] = {"armed": armed, "disarmed": disarmed,
                        "armed_over_disarmed": [a / b for a, b in zip(armed, disarmed)]}
        result["armed_vs_disarmed"] = ratio
        log_timing("observability armed vs disarmed", ratio)
        # The loop sanitizer's gauges, read after every burst: each front
        # end's on the armed plane finite and >= 0, and above 0 after at
        # least one burst (a sanitizer that never publishes reads 0.0);
        # the disarmed plane's the always-emitted 0.0.
        check(all(v >= 0.0 and math.isfinite(v) for v in sum(lags["armed"].values(), [])),
              f"armed loop-lag gauges {lags['armed']}")
        check(all(max(per) > 0.0 for per in lags["armed"].values()),
              f"an armed front end never published a loop lag: {lags['armed']}")
        check(all(v == 0.0 for v in sum(lags["disarmed"].values(), [])),
              f"disarmed loop-lag gauges {lags['disarmed']}")
        if device == "cuda":
            check(launches > 0, "quant_fused never launched over the armed bursts")
        result["loop_lag_ms"] = {name: {str(w): v for w, v in per.items()}
                                 for name, per in lags.items()}
        log_timing("observability loop lag ms per worker (after each burst)",
                   result["loop_lag_ms"])
        port = planes["armed"][0]
        time.sleep(1.0)  # the span writers' 0.5 s flush
        from mlops_tpu_torch.trace import load_spans

        spans = load_spans(root / "traces")
        ok = [s for s in spans if s["status"] == 200]
        stitched = sum("ring_wait" in s["stages"] for s in ok)
        text = _http(port, "GET", "/metrics")[1].decode()
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            reports = list(pool.map(lambda args: _trace_report(root, *args),
                                    [(), ("--replica", "0"), ("--replica", "1")]))
        per_replica = {r: _stage_table(reports[1 + r]) for r in (0, 1)}
        result["trace"] = {
            "spans": len(spans), "spans_200": len(ok), "stitched_share": stitched / len(ok),
            "dropped": _metric(text, "mlops_tpu_trace_dropped_total"),
            "per_entry": _stage_table(reports[0]), "per_replica": per_replica,
            "padding_waste_pct": _metric(text, "mlops_tpu_padding_waste_pct"),
        }
        check(result["trace"]["stitched_share"] == 1.0,
              f"spans without their engine half: {len(ok) - stitched} of {len(ok)}")
        log_timing("observability trace", result["trace"])
        # (c) /debug/profile through a front end, answered by replica 0.
        answers = [_http(port, "POST", "/debug/profile/start")[0],
                   _http(port, "POST", "/debug/profile/start")[0]]
        _check_burst(_sub_burst(single, list(range(OBS_PROFILE_REQUESTS))),
                     _run_burst(port, _sub_burst(single, list(range(OBS_PROFILE_REQUESTS))),
                                16)[0], "observability profiled burst")
        answers += [_http(port, "POST", "/debug/profile/stop")[0],
                    _http(port, "POST", "/debug/profile/stop")[0]]
        if answers != [200, 409, 200, 409]:
            failed = [line for line in log_path.read_text(errors="replace").splitlines()
                      if "profile" in line or "profiler" in line or "Error" in line][-20:]
            raise SmokeFailure(f"the profile protocol: {answers}; the plane's log: {failed}")
        result["profile"] = _profile_counts(root / "profile")
        primed = [line for line in log_path.read_text(errors="replace").splitlines()
                  if line.startswith("profiler primed in ")]
        result["profile"]["prime_s"] = [float(line.split()[3]) for line in primed]
        if device == "cuda":
            check(result["profile"]["quant_fused_kernel"] + result["profile"]["graph_launches"]
                  > 0, f"the profile names neither the kernel nor a graph: {result['profile']}")
        log_timing("observability profile", result["profile"])
        # (e) kill -9 of replica 0 at rest: the ledger carries on.
        time.sleep(1.2)  # two ledger flushes after the last dispatch
        before = _entry_dispatches(port)
        shard = json.loads((root / "ledger" / "ledger-r0.json").read_text())["entries"]
        pids, _, _ = _ring_log(log_path)
        series = _series(port)
        inc = [int(_replica(series, "incarnation", r)) for r in (0, 1)]
        os.kill(pids["engine 0"], signal.SIGKILL)
        t_kill = time.monotonic()
        _wait_replicas(port, proc, 2, "replica 0's respawn", [inc[0] + 1, inc[1]])
        kill_to_ready = time.monotonic() - t_kill
        carried = _entry_dispatches(port)
        check(carried == before, f"ledger dispatches {before} before the kill, {carried} after")
        probe = _sub_burst(single, list(range(OBS_RESPAWN_REQUESTS)))
        _check_burst(probe, _run_burst(port, probe, 1)[0], "after replica 0's respawn")
        deadline = time.monotonic() + 10
        while _entry_dispatches(port) < before + OBS_RESPAWN_REQUESTS:
            check(time.monotonic() < deadline, "the respawned ledger does not count")
            time.sleep(0.05)
        time.sleep(1.2)
        ranked = _trace_report(root, "--ledger")
        result["ledger"] = {
            "dispatches_before_kill": before, "after_respawn": carried,
            "replica_0_shard_dispatches": sum(v["dispatches"] for v in shard.values()),
            "after_probe": _entry_dispatches(port), "kill_to_ready_s": kill_to_ready,
            "ranked": [{k: e[k] for k in ("key", "cost_ms_per_row", "cost_ms_per_dispatch",
                                          "dispatches", "padding_waste_pct")}
                       for e in ranked["entries"]],
        }
        log_timing("observability ledger", result["ledger"])
        for _, _, proc, _ in planes.values():  # both drain at once
            proc.send_signal(signal.SIGTERM)
        for name, (port, _, proc, log_path) in planes.items():
            check(proc.wait(timeout=180) == 0, f"the {name} plane did not exit 0")
            pids, _, text = _ring_log(log_path)
            for w in range(RING_WORKERS):
                check(f"frontend {w} (pid {pids[f'frontend {w}']}) exited 0" in text,
                      f"{name}: front end {w} did not exit 0")
    finally:
        for _, out, proc, _ in planes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
    result["degraded"] = _degraded_fallback(bundle_dir, device)
    result["launches"] = launches
    result["quant_dispatches"] = quant
    return result


def _degraded_fallback(bundle_dir: Path, device: str) -> dict:
    """(f): the quant tier's bucket 8 and group 2x1 without their graphs,
    their captures raising at ``serve.engine.compile``: each dispatch
    replays the next larger graph (bucket 64, group 4x1) and answers
    bitwise as the warmed shape did on the same rows."""
    import numpy as np

    from mlops_tpu_torch import faults
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.schema.validate import records_to_columns
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.metrics import robustness_lines

    bundle = load_bundle(bundle_dir)
    engine = InferenceEngine(bundle, serve_tier="quant", device=device)
    engine.warmup()
    ds = bundle.preprocessor.encode(records_to_columns(_records(5, seed=35)))
    solo = (ds.cat_ids[:3], ds.numeric[:3])
    parts = [(ds.cat_ids[i:i + 1], ds.numeric[i:i + 1]) for i in (3, 4)]
    want = (engine.fetch_arrays_raw(engine.dispatch_arrays(*solo)),
            engine.fetch_group_raw(engine.dispatch_group_arrays(parts)))
    for key in (("quant", (8,)), ("quant", (2, 1))):
        if engine._use_graphs:
            engine._gen.graphs.pop(key)
        else:
            engine._gen.warmed.discard(key)
    faults.arm(faults.FaultPlan.from_rules([{"point": "serve.engine.compile", "mode": "raise"}]))
    try:
        solo_handle = engine.dispatch_arrays(*solo)
        group_handle = engine.dispatch_group_arrays(parts)
        got = (engine.fetch_arrays_raw(solo_handle), engine.fetch_group_raw(group_handle))
    finally:
        faults.disarm()
    check((solo_handle.rows, group_handle.slots, group_handle.rows) == (64, 4, 1),
          f"degraded shapes {solo_handle.rows} {group_handle.slots}x{group_handle.rows}")
    same = all(np.array_equal(a, b) for a, b in zip(want[0], got[0]))
    sizes = got[1][0]
    same = same and all(np.array_equal(want[1][k][i, :n] if k < 3 else want[1][k][i],
                                       got[1][k][i, :n] if k < 3 else got[1][k][i])
                        for k in (1, 2, 3) for i, n in enumerate(sizes))
    # On the card each row is its own warp of quant_fused: bitwise. The
    # CPU route's plain version computes other batch shapes in another
    # order, so a rehearsal there reads the gap instead.
    gap = max(float(np.abs(a - b).max()) for a, b in zip(want[0], got[0]))
    check(same or device != "cuda",
          "a degraded dispatch answered differently from its warmed shape")
    lines = robustness_lines(0, engine.degraded_dispatch_total)
    counted = _metric("\n".join(lines), "mlops_tpu_degraded_dispatch_total")
    check(counted == 2, f"mlops_tpu_degraded_dispatch_total {counted}")
    out = {"served_through": ["bucket_64", "group_4x1"], "bitwise": same, "max_gap": gap,
           "degraded_dispatch_total": counted, "entries": [solo_handle.entry, group_handle.entry]}
    log_timing("observability degraded fallback", out)
    return out


AUTO_GRID = (1, 8, 64, 256)  # serve.warmup_batch_sizes as shipped
AUTO_CONNECTIONS = 16
AUTO_ROUND = 400  # requests per traffic round at AUTO_CONNECTIONS
AUTO_POOL = 300  # distinct request bodies the rounds cycle through
AUTO_AFTER_S = 2.0  # traffic kept up once the sibling adopted
AUTO_AFTER_ROUNDS = 3  # at least this many rounds on the regridded plane
AUTO_DEADLINE_S = 120
AUTO_PROBE_REPEATS = 8  # the probe, one at a time, after the regrid
AUTO_FRESH = """
import json, sys
from mlops_tpu_torch import faults
from mlops_tpu_torch.autotune import apply_plan
from mlops_tpu_torch.bundle import load_bundle
from mlops_tpu_torch.ops import cuda_build
from mlops_tpu_torch.ops.quant_kernel import quant_kernel_launches
from mlops_tpu_torch.serve.engine import InferenceEngine
cuda_build.set_cache_dir({cache!r})
engine = InferenceEngine(load_bundle({bundle!r}), buckets={grid!r}, serve_tier="quant",
                         device={device!r})
engine.warmup()
probe = json.loads({probe!r})
if {kill!r}:
    faults.arm(faults.FaultPlan.from_rules(
        [{{"point": "autotune.regrid.midswap", "mode": "kill"}}]))
    apply_plan(engine, {plan!r})
    raise SystemExit("the kill fault did not fire")
def served():
    before = (engine.dispatch_counts(), quant_kernel_launches.value)
    body = engine.predict_records_wire(probe).decode()
    counts = engine.dispatch_counts()
    entry = [k for k in counts if counts[k] != before[0].get(k, 0)]
    return {{"body": body, "entries": entry,
            "launches": quant_kernel_launches.value - before[1]}}
out = {{"old_grid": served(), "grid_generations": [engine.grid_generation]}}
out["regrid_generation"] = apply_plan(engine, {plan!r})
out["swap_stats"] = engine.swap_stats
out["new_grid"] = served()
out["buckets"] = list(engine.buckets)
engine.rollback()
out["rollback_stats"] = engine.swap_stats
out["grid_generations"].append(engine.grid_generation)
out["rolled_back"] = served()
out["rolled_back_buckets"] = list(engine.buckets)
print(json.dumps(out))
"""


def _auto_env(root: Path) -> dict:
    """The autotuner armed through the environment layer on the quant
    tier alone: tracing (the demand input), the cost ledger (the cost
    input) and the controller with its clocks cut (interval 60 -> 2 s,
    cooldown 300 -> 30 s) and its gain floor at 0 (the card's flat cost
    per dispatch must not hold the phase's one regrid back)."""
    return {
        "MLOPS_TPU_SERVE_SERVE_TIER": "quant", "MLOPS_TPU_SERVE_TIER_ROUTING": "false",
        "MLOPS_TPU_SERVE_WARMUP_BATCH_SIZES": ",".join(map(str, AUTO_GRID)),
        "MLOPS_TPU_TRACE_ENABLED": "true", "MLOPS_TPU_TRACE_DIR": str(root / "traces"),
        "MLOPS_TPU_SLO_LEDGER_DIR": str(root / "ledger"),
        "MLOPS_TPU_AUTOTUNE_ENABLED": "true", "MLOPS_TPU_AUTOTUNE_INTERVAL_S": "2",
        "MLOPS_TPU_AUTOTUNE_MIN_DISPATCHES": "200", "MLOPS_TPU_AUTOTUNE_COOLDOWN_S": "30",
        "MLOPS_TPU_AUTOTUNE_MIN_GAIN_PCT": "0",
        "MLOPS_TPU_AUTOTUNE_PLAN_DIR": str(root / "autotune"),
    }


def _skewed_set(bundle, cpu, seed: int) -> dict:
    """AUTO_POOL requests shaped so the shipped grid pads badly (85 %
    carry 2-3 records, 10 % one, 5 % 30-40), with the CPU route's quant
    answers, in ``_burst_set``'s form."""
    import numpy as np
    import torch

    from mlops_tpu_torch.schema.validate import records_to_columns

    rng = np.random.default_rng(seed)
    u = rng.random(AUTO_POOL)
    sizes = np.where(u < 0.10, 1, np.where(u < 0.95, rng.integers(2, 4, AUTO_POOL),
                                           rng.integers(30, 41, AUTO_POOL)))
    pool = _records(int(sizes.sum()), seed, drift=0.3)
    bounds = np.cumsum([0, *sizes])
    requests = [pool[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    wants = [cpu.predict_records(r) for r in requests]
    ds = bundle.preprocessor.encode(records_to_columns(pool))
    near = _near_threshold(bundle.monitor, torch.from_numpy(ds.numeric),
                           torch.ones(len(pool), dtype=torch.bool)).numpy()
    return {
        "kind": "skewed",
        "bodies": [json.dumps(r).encode() for r in requests],
        "headers": [""] * AUTO_POOL,
        "rows": int(sizes.sum()),
        "want": [(np.asarray(w["predictions"]),
                  np.asarray(list(w["feature_drift_batch"].values())),
                  np.asarray(w["outliers"])) for w in wants],
        "off_band": [~near[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])],
        "tol": [(PRED_ATOL, DRIFT_ATOL)] * AUTO_POOL,
        "sizes": sizes.tolist(),
    }


def _auto_script(bundle_dir: Path, cache: Path, device: str, probe: bytes, plan,
                 kill: bool) -> subprocess.Popen:
    script = AUTO_FRESH.format(cache=str(cache), bundle=str(bundle_dir), grid=AUTO_GRID,
                               device=device, probe=probe.decode(), plan=tuple(plan),
                               kill=kill)
    return subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))


def _probe(port: int, body: bytes) -> bytes:
    status, answer = _http(port, "POST", "/predict", body)
    check(status == 200, f"the probe answered {status}: {answer[:200]}")
    return answer


def phase_autotune(bundle_dir: Path, device: str = "cuda") -> dict:
    """Phase 36: the traffic-shape autotuner on the ring plane as the
    image starts it (``--workers 2 --replicas 2``), phase 22's bundle on
    its quant tier, phase 29's warmed cache, the grid (1, 8, 64, 256) as
    shipped; armed through ``MLOPS_TPU_*`` (``_auto_env``). Skewed traffic
    at 16 connections, every answer against the CPU route, until the
    lead replica applies a plan and the sibling adopts it, then a few
    seconds more: (1) the lead's plan differs from the shipped grid and
    keeps 256, ``plan.json`` says applied; (2) ``mlops_tpu_grid_generation``
    reads 2 (the MIN over the replicas) and the applied plans count; (3)
    every request answers 200 and a 3-record probe answers the same bytes
    before and after the regrid; (4) the probe, one at a time after it,
    dispatches through a bucket the plan added, each a ``quant_fused``
    launch from that bucket's graph. After the drain (5) ``autotune`` on
    the plane's flushed ledger and spans prints one plan, exit 0 or 3;
    (6) a subprocess armed with a kill at ``autotune.regrid.midswap``
    dies by SIGKILL inside ``apply_plan``, and a fresh one on the same
    bundle and cache answers the probe on the old grid, regrids to the
    lead's plan and rolls it back, the same answer each time. Each
    replica's regrid record (graphs captured, capture s, pool bytes, the
    exchange's critical µs), the predicted and measured gains and
    requests/s per round before and after the regrid are logged."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    root = WORK / "autotune"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache = WORK / "ring" / "cache"
    _warm_cache(bundle_dir, cache, device)
    bundle = load_bundle(bundle_dir)
    cpu = InferenceEngine(bundle, device="cpu", serve_tier="quant")
    pool = _skewed_set(bundle, cpu, seed=36)
    probe_body = json.dumps(_records(3, seed=360)).encode()
    # The mid-regrid kill overlaps the plane's boot: it needs no plan of
    # the lead's, only one that adds buckets.
    killed = _auto_script(bundle_dir, cache, device, probe_body, (1, 2, 3, 40, 256),
                          kill=True)
    port = _free_port()
    log_path = root / "plane.log"
    out_file = open(log_path, "wb")
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           **_image_env(bundle_dir, cache, port, RING_WORKERS, device), **_auto_env(root)}
    proc = subprocess.Popen(_cli(["serve", "--workers", str(RING_WORKERS), "--replicas", "2"]),
                            cwd=ROOT, stdout=out_file, stderr=subprocess.STDOUT, env=env)
    result: dict = {}
    fresh = None
    try:
        _wait_ready(port, proc, "the autotune plane")
        _wait_replicas(port, proc, 2, "the autotune plane")
        # Both controllers armed before the traffic: the render's MIN folds
        # the armed replicas only.
        deadline = time.monotonic() + 60
        while (text := log_path.read_text(errors="replace")).count(
                "autotune controller started") < 2:
            check(time.monotonic() < deadline, "the plane's autotune controllers")
            time.sleep(0.05)
        check("(replica 1, adopt mode)" in text, "replica 1's controller is not in adopt mode")
        probes = [_probe(port, probe_body) for _ in range(4)]
        check(len(set(probes)) == 1, "the probe's answers differ before the regrid")
        plan_path = root / "autotune" / "plan.json"
        rng = np.random.default_rng(36)
        rounds = []
        launches = dispatches = 0.0
        t0 = time.monotonic()
        applied_at = adopted_at = None
        while True:
            idx = rng.integers(0, AUTO_POOL, AUTO_ROUND).tolist()
            burst = _sub_burst(pool, idx)
            before = _scrape(port)
            grid_before = _series(port).get("mlops_tpu_grid_generation", 0.0)
            out, lat, wall = _run_burst(port, burst, AUTO_CONNECTIONS)
            worst = _check_burst(burst, out, f"autotune round {len(rounds)}")
            after = _scrape(port)
            series = _series(port)
            grid = series.get("mlops_tpu_grid_generation", 0.0)
            launches += after["launches"] - before["launches"]
            dispatches += after["dispatches"] - before["dispatches"]
            if applied_at is None and plan_path.is_file():
                applied_at = time.monotonic()
            if adopted_at is None and grid >= 2:
                adopted_at = time.monotonic()
            rounds.append({
                "round": len(rounds), "t_s": round(time.monotonic() - t0, 3),
                "window": ("after" if grid_before >= 2 else
                           "before" if applied_at is None else "between"),
                "requests_per_s": len(idx) / wall,
                "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                "dispatches_per_request": (after["dispatches"] - before["dispatches"]) / len(idx),
                "max_pred_err": worst["pred"], "grid_generation": grid})
            log_timing("autotune round", rounds[-1])
            # The measured gain needs the lead's next tick after the apply;
            # the traffic waits a while for it, never forever.
            if (adopted_at is not None
                    and sum(r["window"] == "after" for r in rounds) >= AUTO_AFTER_ROUNDS
                    and time.monotonic() - adopted_at >= AUTO_AFTER_S
                    and ("mlops_tpu_autotune_measured_gain_pct" in series
                         or time.monotonic() - adopted_at >= 3 * AUTO_AFTER_S)):
                break
            check(time.monotonic() - t0 < AUTO_DEADLINE_S,
                  f"no regrid on both replicas within {AUTO_DEADLINE_S} s "
                  f"(grid_generation {grid}, plan {plan_path.is_file()})")
        plan = json.loads(plan_path.read_text())
        buckets = tuple(plan["buckets"])
        check(plan["applied"] and plan["replica"] == 0 and buckets != AUTO_GRID
              and buckets[-1] == AUTO_GRID[-1], f"the lead's plan: {plan}")
        # The fresh process (6) needs only the lead's plan: it starts while
        # this plane answers the probes and drains.
        fresh = _auto_script(bundle_dir, cache, device, probe_body, buckets, kill=False)
        series = _series(port)
        check(series["mlops_tpu_grid_generation"] == 2
              and series['mlops_tpu_autotune_plans_total{outcome="applied"}'] >= 1,
              "grid generation and applied plans on /metrics")
        # (3) + (4): the probe on the regridded plane, one at a time.
        target = min(b for b in buckets if b >= 3)
        entry = f'mlops_tpu_dispatches_total{{entry="bucket_{target}"}}'
        before, entry_before = _scrape(port), _series(port).get(entry, 0.0)
        after_probes = [_probe(port, probe_body) for _ in range(AUTO_PROBE_REPEATS)]
        after, entry_after = _scrape(port), _series(port).get(entry, 0.0)
        bitwise = set(after_probes) == {probes[0]}
        check(bitwise or device != "cuda", "the probe answers differently after the regrid")
        check(target not in AUTO_GRID, f"the probe's bucket {target} is not a new one")
        # Every dispatch of the probes, and each through the new bucket.
        check(after["dispatches"] - before["dispatches"] == AUTO_PROBE_REPEATS
              and entry_after - entry_before == AUTO_PROBE_REPEATS,
              f"the probe did not dispatch through bucket_{target}: "
              f"{entry_after - entry_before} of {AUTO_PROBE_REPEATS}")
        if device == "cuda":
            check(after["launches"] - before["launches"] == AUTO_PROBE_REPEATS,
                  "quant_fused launches of the probe through the new bucket's graph")
        regrids = [json.loads(line.split(": ", 1)[1])
                   for line in log_path.read_text(errors="replace").splitlines()
                   if line.startswith("autotune regrid ")]
        check(sorted(r["replica"] for r in regrids) == [0, 1], f"regrid records: {regrids}")
        if device == "cuda":
            # One launch per dispatch, and one per capture: each new graph's
            # eager pass before it is captured.
            captured = sum(r["graphs"] for r in regrids)
            check(launches == dispatches + captured, f"{launches} quant_fused launches for "
                  f"{dispatches} quant-tier dispatches and {captured} captures")
        windows = {w: [r["requests_per_s"] for r in rounds if r["window"] == w]
                   for w in ("before", "after")}
        result.update({
            "plan": {k: plan[k] for k in ("buckets", "baseline_buckets", "predicted_gain_pct",
                                          "predicted_waste_pct", "baseline_waste_pct",
                                          "cost_model", "demand_dispatches")},
            "regrids": regrids,
            "predicted_gain_pct": series.get("mlops_tpu_autotune_predicted_gain_pct"),
            "measured_gain_pct": series.get("mlops_tpu_autotune_measured_gain_pct"),
            "requests_per_s": {w: {"rounds": v, "median": float(np.median(v)) if v else None,
                                   "spread": [min(v), max(v)] if v else None}
                               for w, v in windows.items()},
            "rounds": len(rounds), "requests": len(rounds) * AUTO_ROUND,
            "apply_after_s": None if applied_at is None else applied_at - t0,
            "adopt_after_s": adopted_at - t0, "probe_bucket": target,
            "probe_bitwise": bitwise, "launches": launches, "dispatches": dispatches,
        })
        log_timing("autotune regrid", {k: result[k] for k in (
            "plan", "regrids", "predicted_gain_pct", "measured_gain_pct", "requests_per_s",
            "apply_after_s", "adopt_after_s", "probe_bucket", "probe_bitwise")})
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=180) == 0, "the autotune plane did not exit 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        out_file.close()
        for sub in (killed, fresh):
            if sub is not None and sub.poll() is None and not result:
                sub.kill()
    # (6) the kill, then a fresh process; (5) the offline command beside it.
    _, err = killed.communicate(timeout=300)
    check(killed.returncode == -signal.SIGKILL,
          f"the mid-regrid kill: exit {killed.returncode}\n{err[-2000:]}")
    offline = subprocess.run(_cli(["autotune", f"slo.ledger_dir={root / 'ledger'}",
                                   f"trace.dir={root / 'traces'}"]),
                             cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                             capture_output=True, text=True, timeout=120)
    lines = offline.stdout.strip().splitlines()
    check(offline.returncode in (0, 3) and len(lines) == 1,
          f"autotune: exit {offline.returncode} {offline.stdout[-500:]} {offline.stderr[-2000:]}")
    doc = json.loads(lines[0])
    check(doc["buckets"][-1] == AUTO_GRID[-1], f"the offline plan: {doc}")
    result["offline"] = {"exit": offline.returncode, "buckets": doc["buckets"],
                         "predicted_gain_pct": doc["predicted_gain_pct"],
                         "regrid_warranted": doc["regrid_warranted"]}
    stdout, err = fresh.communicate(timeout=300)
    check(fresh.returncode == 0, f"the fresh process: {fresh.returncode}\n{err[-3000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    answers = [report[k]["body"] for k in ("old_grid", "new_grid", "rolled_back")]
    same = all(json.loads(a) == json.loads(probes[0]) for a in answers)
    check(same or device != "cuda", "the fresh process's probe answers differ")
    check(report["old_grid"]["entries"] == ["bucket_8"]
          and report["new_grid"]["entries"] == [f"bucket_{target}"]
          and report["rolled_back"]["entries"] == ["bucket_8"]
          and report["grid_generations"] == [1, 3] and report["regrid_generation"] == 2
          and report["rolled_back_buckets"] == list(AUTO_GRID),
          f"the fresh process's regrid: {report}")
    if device == "cuda":
        check(report["new_grid"]["launches"] == 1, "quant_fused in the new bucket's graph")
    result["fresh"] = {"swap_stats": report["swap_stats"],
                       "rollback_stats": report["rollback_stats"],
                       "entries": [report[k]["entries"][0]
                                   for k in ("old_grid", "new_grid", "rolled_back")],
                       "bitwise": same, "killed": "SIGKILL"}
    log_timing("autotune offline and fresh process", {"offline": result["offline"],
                                                      "fresh": result["fresh"]})
    return result


def _pyarrow_version() -> str | None:
    """pyarrow's version where it imports (the optional dependency the JAX
    package gates too), else None."""
    try:
        import pyarrow
    except ImportError:
        return None
    return pyarrow.__version__


# ----------------------------------------------------------------- phase 37
GBM_SOLO = (1, 8, 64, 256)  # buckets; each request fills 3/4 of its bucket (1 row at 1)
GBM_SOLO_ROWS = {1: 256, 8: 768}  # fixture rows sent at the small buckets (else all)
GBM_GROUPS = ((64, 1), (64, 8))
GBM_TIMED = ((1, 1), (1, 256), (64, 1), (64, 8))
GBM_REPLAYS = 200  # graph replays between two events, per timed geometry
GBM_PROFILED = 20  # replays under torch.profiler, per timed geometry
GBM_REQUESTS = 300  # single-record requests per plane and concurrency
GBM_CONCURRENCY = (16, 64)


def _gbm_fixture_module():
    """``scripts/torch_gbm_fixture.py`` as a module (the fixture's reader
    and bundle builder; numpy and the port only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_gbm_fixture", ROOT / "scripts" / "torch_gbm_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gbm_drive(engine, s: int, b: int, cat, num):
    """The fixture rows through ``engine`` at one geometry: solo requests
    of 3/4 of bucket ``b`` (one row at 1), or groups of ``s`` requests of
    ``b`` rows. Returns the predictions in row order and each request's
    (outliers, drift)."""
    import numpy as np

    preds, monitors = [], []
    if s == 1:
        step = max(1, b - b // 4)
        for lo in range(0, len(cat), step):
            p, o, d = engine.fetch_arrays_raw(
                engine.dispatch_arrays(cat[lo:lo + step], num[lo:lo + step]))
            preds.append(p)
            monitors.append((o, d))
    else:
        for lo in range(0, len(cat), s * b):
            parts = [(cat[i:i + b], num[i:i + b])
                     for i in range(lo, min(lo + s * b, len(cat)), b)]
            sizes, p, o, d = engine.fetch_group_raw(engine.dispatch_group_arrays(parts))
            for i, n in enumerate(sizes):
                preds.append(p[i, :n])
                monitors.append((o[i, :n], d[i]))
    return np.concatenate(preds), monitors


def _gbm_plane_burst(port: int, bodies: list, wants: list, concurrency: int,
                     what: str) -> dict:
    """``bodies`` at ``concurrency`` connections: every answer 200 and the
    engine's (predictions and flags bitwise, drift within 1e-5);
    requests/s and latency percentiles."""
    import numpy as np

    out, lat, wall = _run_burst(port, {"bodies": bodies, "headers": [""] * len(bodies)},
                                concurrency)
    drift_bitwise = 0
    for i, (status, payload) in enumerate(out):
        check(status == 200, f"{what}: request {i} answered {status}: {payload[:200]}")
        got, want = json.loads(payload), wants[i]
        check(got["predictions"] == want["predictions"] and got["outliers"] == want["outliers"],
              f"{what}: request {i} differs from the engine: {got} vs {want}")
        err = max(abs(got["feature_drift_batch"][k] - v)
                  for k, v in want["feature_drift_batch"].items())
        check(err <= DRIFT_ATOL + 1e-6, f"{what}: request {i} drift off by {err:.3g}")
        drift_bitwise += got["feature_drift_batch"] == want["feature_drift_batch"]
    return {"requests": len(bodies), "concurrency": concurrency,
            "requests_per_s": len(bodies) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "drift_bitwise": drift_bitwise}


def phase_gbm(device: str = "cuda") -> dict:
    """Phase 37: the gbm tier on the card at the job's full width (see the
    module docstring)."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.gbm_tensor import gbm_graph_replays, gbm_tensor_bytes
    from mlops_tpu_torch.serve.engine import InferenceEngine

    fixture_module = _gbm_fixture_module()
    root = WORK / "gbm"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    bundle_dir = fixture_module.fixture_bundle(root / "bundle")
    fixture = fixture_module.read_fixture()
    bundle = load_bundle(bundle_dir)
    check(bundle.estimator is None and bundle.gbm_tensor is not None,
          "the fixture bundle must serve from its tree file alone")
    geometry = bundle.gbm_tensor[1]
    card = InferenceEngine(bundle, device=device)
    card.warmup()
    cpu = InferenceEngine(load_bundle(bundle_dir), device="cpu")
    cpu.warmup()
    tier = card._tiers["gbm"]
    graphs = device == "cuda"  # the CPU route (a dry run off the card) runs eagerly
    check(all(t.device.type == device for t in tier.params.values())
          and tier.params["value"].dtype == tier.params["threshold"].dtype == torch.float64
          and tier.temperature.dtype == torch.float64,
          f"the gbm tier's tree tensors and temperature must be f64 on {device}")
    check(card.warmup_stats["programs"] == 16 and (
        not graphs or card.warmup_stats["route"] == "cuda_graphs" and len(card._graphs) == 16),
        f"gbm warmup: {card.warmup_stats}")
    build_s = time.perf_counter() - t0
    log_timing("gbm bundle and warmup", {"s": build_s, **card.warmup_stats,
                                         "geometry": dataclasses.asdict(geometry),
                                         "temperature": bundle.temperature})

    cat, num, probs = fixture["cat_ids"], fixture["numeric"], fixture["probs"]
    gbm_graph_replays.reset()
    before = sum(card.dispatch_counts().values())
    parity = []
    for s, b in [(1, b) for b in GBM_SOLO] + list(GBM_GROUPS):
        rows = GBM_SOLO_ROWS.get(b, len(cat)) if s == 1 else len(cat)
        got, got_mon = _gbm_drive(card, s, b, cat[:rows], num[:rows])
        want, want_mon = _gbm_drive(cpu, s, b, cat[:rows], num[:rows])
        mismatched = int((got.astype(np.float32) != probs[:rows]).sum())
        cpu_mismatched = int((want.astype(np.float32) != probs[:rows]).sum())
        flag_diff = sum(int((o1 != o2).sum()) for (o1, _), (o2, _) in zip(got_mon, want_mon))
        drift_err = max(float(np.abs(d1 - d2).max()) for (_, d1), (_, d2) in zip(got_mon, want_mon))
        inputs = _inputs(bundle.preprocessor, s, b, 3700 + s + b, "cpu")
        if s == 1:
            inputs = tuple(t[0] for t in inputs)
        stats = [_monitor_statistics(mon, *(t.to(mon.out_mean.device) for t in inputs))
                 for mon in (card._monitor, cpu._monitor)]
        stats_exact = all(torch.equal(x.cpu(), y) for x, y in zip(*stats))
        row = {"geometry": f"{s}x{b}", "rows": rows, "requests": len(got_mon),
               "pred_mismatches": mismatched, "cpu_pred_mismatches": cpu_mismatched,
               "flag_mismatches": flag_diff, "drift_err": drift_err,
               "counts_ks_exact": stats_exact}
        log_timing("gbm parity", row)
        check(mismatched == 0 and cpu_mismatched == 0,
              f"gbm {s}x{b}: {mismatched} card / {cpu_mismatched} CPU predictions differ "
              "from scikit-learn's recorded probabilities")
        check(flag_diff == 0 and drift_err <= DRIFT_ATOL and stats_exact,
              f"gbm {s}x{b}: the card's monitors disagree with the CPU route: {row}")
        parity.append(row)
    dispatches = sum(card.dispatch_counts().values()) - before
    replays = gbm_graph_replays.value
    check(dispatches > 0 and replays == (dispatches if graphs else 0),
          f"gbm: {replays} graph replays for {dispatches} dispatches")
    snap_card, snap_cpu = card.monitor_snapshot(), cpu.monitor_snapshot()
    check(all(snap_card[k] == snap_cpu[k] for k in ("rows", "outliers", "batches"))
          and np.abs(np.asarray(snap_card["drift_sum"]) - snap_cpu["drift_sum"]).max()
          <= DRIFT_ATOL * snap_card["batches"],
          f"gbm accumulators: card {snap_card} vs CPU {snap_cpu}")
    log(f"gbm: {dispatches} dispatches, {replays} graph replays, accumulators agree "
        f"({snap_card['rows']:.0f} rows, {snap_card['batches']:.0f} batches)")

    timing = []
    for s, b in GBM_TIMED if graphs else ():
        graph = card._graphs["gbm", (b,) if s == 1 else (s, b)]
        with torch.cuda.stream(card._stream):
            us = _event_ms(graph.replay, GBM_REPLAYS) * 1e3
            profile = _route_profile(graph.replay, GBM_PROFILED)
        row = {"geometry": f"{s}x{b}", "device_us_per_replay": us,
               "kernels_per_replay": profile["device_ops"],
               "device_busy_share": profile["device_busy_share"],
               "dispatch_fetch_ms_p50": _dispatch_fetch_p50(
                   card, bundle.preprocessor, s, b, 3800 + s + b)}
        log_timing("gbm timing", row)
        timing.append(row)
    card.monitor_snapshot()  # the timed replays' folds, off the record

    # The planes: the image's environment, single-process and ring.
    records = _records(GBM_REQUESTS, 3900, drift=0.3)
    bodies = [json.dumps([r]).encode() for r in records]
    wants = [card.predict_records([r]) for r in records]
    base_env = dict(os.environ, PYTHONPATH=str(ROOT))
    planes, served = {}, []
    try:
        for mode, workers in (("ring", RING_WORKERS), ("single", 0)):
            port = _free_port()
            log_path = root / f"serve_{mode}.log"
            out = open(log_path, "wb")
            planes[mode] = (port, out, subprocess.Popen(
                _cli(["serve"]), cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                env={**base_env, **_image_env(bundle_dir, root / "cache", port, workers,
                                              device)}), log_path)
        for mode, (port, _, proc, log_path) in planes.items():
            _wait_ready(port, proc, f"gbm {mode} plane")
            before = _scrape(port)
            for concurrency in GBM_CONCURRENCY:
                row = {"plane": mode, **_gbm_plane_burst(
                    port, bodies, wants, concurrency, f"gbm {mode} plane")}
                log_timing("gbm serve", row)
                served.append(row)
            _await_rows(port, before, len(bodies) * len(GBM_CONCURRENCY), f"gbm {mode} plane")
        check("tiers=gbm" in planes["ring"][3].read_text(errors="replace"),
              "the ring engine does not serve the gbm tier")
    finally:
        for mode, (port, out, proc, log_path) in planes.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait(timeout=30)
            out.close()
            check(code == 0, f"gbm {mode} plane exited {code}: "
                  f"{log_path.read_text(errors='replace')[-2000:]}")
    loaded = sorted(m for m, mod in sys.modules.items()
                    if m.split(".")[0] in ("sklearn", "joblib") and mod is not None)
    check(not loaded, f"phase 37 loaded {loaded}")
    result = {
        "fixture": {"n_trees": geometry.n_trees, "max_nodes": geometry.max_nodes,
                    "depth": geometry.depth, "rows": int(len(probs)),
                    "sklearn_version": str(fixture["sklearn_version"]),
                    "temperature": bundle.temperature},
        "parity": parity,
        "dispatches": dispatches,
        "replays": replays,
        "timing": timing,
        "serve": served,
        "tree_tensor_bytes": gbm_tensor_bytes(tier.params),
        "graph_pool_bytes": card.warmup_stats.get("graph_pool_bytes"),
        "capture_s": card.warmup_stats.get("capture_s"),
        "sklearn_loaded": loaded,
    }
    log_timing("gbm bytes", {k: result[k] for k in ("tree_tensor_bytes", "graph_pool_bytes",
                                                    "capture_s")})
    return result


# ----------------------------------------------------------------- phase 38
# The rest of the transformer families at full width. The moe family at
# its only definition, the ModelConfig defaults (token_dim 64, depth 3,
# 8 heads, 8 experts of F = 256: 853,785 parameters), trained as phase 19
# trains the other families (steps cut) with its bulk student; BERT-base
# (hidden 768, depth 12, 12 heads) pretrained with the masked-feature
# objective, then fine-tuned from that file (steps cut, no bulk student:
# phase 23 covers the students); a 4-member FT-Transformer ensemble at
# the config's widths, seeded, on the exact tier.
A9_MOE = ("model.family=moe",)
A9_MOE_STEPS = 200  # of the job's 2,000, as phase 19 cuts the other families
A9_MOE_EVAL_EVERY = 100
BERT_BASE = ("model.family=bert", "model.token_dim=768", "model.depth=12", "model.heads=12")
# pretrain_bert's own default rate: the job's 3e-3 is the classifier's
# warmed-up peak, and the pretraining optimizer has no warmup
A9_PRETRAIN = ("train.steps=40", "train.learning_rate=3e-4")  # of the job's 2,000
A9_FINETUNE = ("train.steps=40", "train.eval_every=20", "train.distill_bulk=false")
A9_ENSEMBLE = ("model.family=ft_transformer", "model.ensemble_size=4")
A9_TIE_GAP = 1e-6  # a token whose 2nd and 3rd gates are this close may route apart
A9_AUX_RTOL = 1e-3
A9_TUNE_TRIALS = 2
A9_TIMED_WINDOWS = 3
A9_TIMED_STEPS = 5
A9_PROFILED_STEPS = 3
A9_P50_DISPATCHES = 50


def _finish_pretrain_cli(started) -> tuple[dict, float]:
    """The started ``pretrain`` run's JSON line: the file, its row count
    and a loss curve of 10 finite buckets that falls."""
    proc, err, log_path, t0 = started
    try:
        stdout, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"pretrain exited {proc.returncode}: {log_path.read_text()[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    log(f"pretrain: {wall:.1f} s: {json.dumps(out)}")
    curve = out["loss_curve"]
    check(set(out) == {"pretrained", "rows", "loss_curve"}, f"pretrain printed {sorted(out)}")
    check(len(curve) == 10 and all(math.isfinite(v) for v in curve),
          f"pretrain loss curve {curve}")
    check(curve[-1] < curve[0], f"the pretraining loss did not fall: {curve}")
    check(Path(out["pretrained"]).name == "pretrained.msgpack" and Path(out["pretrained"]).exists(),
          f"pretrain wrote {out['pretrained']}")
    return out, wall


def _a9_moe_parity(extra, device: str, train_ds) -> dict:
    """The moe at full width, dropout 0, one seeded init on the card and
    on the CPU, one batch of the job's: the eval probabilities, the
    training forward's auxiliary and ``training_loss``'s gradients leaf by
    leaf; block 0's routing masks on the same tokens, exact but for
    near-ties (counted)."""
    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train import loop

    config = _job_config([*A9_MOE, "model.dropout=0.0", *extra], device)
    host = _tensors(train_ds, "cpu")
    idx = torch.from_numpy(loop.batch_indices(host[0].shape[0], config.train.batch_size, 0, 1))
    batch = tuple(t[idx] for t in host)
    seen = {}
    probs, aux, grads, routes = {}, {}, {}, {}
    for dev in (device, "cpu"):
        model = init_params(build_model(config.model), 0).to(dev)
        ffn = model.block_0.MoEFeedForward_0
        if dev == "cpu":
            hook = ffn.register_forward_pre_hook(lambda m, args: seen.update(x=args[0]))
        cat, num, lab = (t.to(dev) for t in batch)
        with torch.no_grad():
            probs[dev] = torch.sigmoid(model(cat, num)).float().cpu()
        out = model(cat, num, train=True)
        aux[dev] = out[1].detach().float().cpu()
        loop.loss_of(out, lab, config.train.pos_weight).backward()
        grads[dev] = {k: p.grad.float().cpu().flatten() for k, p in model.named_parameters()}
        if dev == "cpu":
            hook.remove()
        routes[dev] = model
    tokens = seen["x"].detach().reshape(-1, seen["x"].shape[-1])
    with torch.no_grad():
        masks = {}
        for dev, model in routes.items():
            gates, mask, _ = model.block_0.MoEFeedForward_0.route(tokens.to(dev))
            masks[dev] = mask.cpu()
            if dev == "cpu":
                ordered = gates.sort(dim=-1, descending=True).values
                ties = (ordered[:, 1] - ordered[:, 2]) < A9_TIE_GAP
    apart = ((masks[device] != masks["cpu"]).any(-1) & ~ties).sum().item()
    stats = []
    for k, want in grads["cpu"].items():
        got = grads[device][k]
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
        ratio = (got.norm() / want.norm().clamp_min(1e-30)).item()
        stats.append((k, cos, ratio))
        check(cos >= GRAD_COSINE_MIN and abs(ratio - 1) <= GRAD_NORM_RTOL,
              f"moe {k}: card vs CPU gradient cosine {cos:.5f}, norm ratio {ratio:.5f}")
    row = {
        "params": sum(g.numel() for g in grads["cpu"].values()),
        "batch": config.train.batch_size,
        "max_prob_err": (probs[device] - probs["cpu"]).abs().max().item(),
        "aux_card": aux[device].tolist(), "aux_cpu": aux["cpu"].tolist(),
        "worst_cosine": min(s[1] for s in stats),
        "worst_norm_ratio": max((s[2] for s in stats), key=lambda r: abs(r - 1)),
        "route_tokens": int(tokens.shape[0]), "route_near_ties": int(ties.sum()),
        "routes_apart_off_ties": int(apart),
    }
    log(f"moe card vs cpu {json.dumps(row)}")
    check(row["max_prob_err"] <= EXACT_PRED_ATOL, f"moe probabilities part: {row}")
    check(torch.allclose(aux[device], aux["cpu"], rtol=A9_AUX_RTOL, atol=0),
          f"moe auxiliaries part: {row}")
    check(apart == 0, f"moe routes part off the near-ties: {row}")
    return row


def _a9_ensemble_bundle(extra) -> Path:
    """A 4-member FT-Transformer ensemble bundle at the config's widths,
    seeded (flax's initializers), over phase 16's synthetic preprocessor
    and monitor."""
    from mlops_tpu_torch.bundle import save_exact_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.monitor.state import fit_monitor

    config = _job_config([*A9_ENSEMBLE, *extra], "cpu").model
    columns, _ = generate_synthetic(20000, seed=0)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=2048)
    model = init_params(build_model(config), 38)
    directory = WORK / "a9" / "ft_ens4"
    shutil.rmtree(directory, ignore_errors=True)
    save_exact_bundle(directory, config, model, prep, monitor,
                      calibration={"temperature": 1.2},
                      tags={"source": "chip_smoke.py", "note": "seeded weights, not trained"})
    log(f"ensemble bundle ft_ens4: {directory} "
        f"({sum(p.numel() for p in model.parameters())} params)")
    return directory


def _a9_graft_check(ft_args, path: str, device: str) -> dict:
    """The fine-tune's initial state: the trunk bit for bit from the
    file, ``pooler`` and ``head`` absent from it and from the fresh init
    of ``train.seed``."""
    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train.pipeline import load_init_state
    from mlops_tpu_torch.train.pretrain import load_pretrained

    config = _job_config(ft_args, device)
    state = load_init_state(config)
    saved = load_pretrained(path, config.model)
    fresh = init_params(build_model(config.model), config.train.seed).state_dict()
    heads = ("pooler", "head")
    grafted = [k for k in state if k.split(".")[0] not in heads]
    kept = [k for k in state if k.split(".")[0] in heads]
    check(all(torch.equal(state[k], saved[k]) for k in grafted),
          "the grafted trunk differs from pretrained.msgpack")
    check(kept and all(k not in saved and torch.equal(state[k], fresh[k]) for k in kept),
          "pooler/head came from the pretrained file, not the fresh init")
    row = {"grafted_leaves": len(grafted), "kept_leaves": len(kept),
           "file_leaves": len(saved), "params": sum(v.numel() for v in state.values())}
    log(f"fine-tune graft {json.dumps(row)}")
    return row


def _a9_steps(step, label: str, rows: int) -> dict:
    """A training step on the card: step ms (CUDA events around each of
    ``A9_TIMED_WINDOWS`` windows after 2 warm-up steps; the median and the
    extremes), rows per second, the device's kernels per step and busy
    share under ``torch.profiler`` with the kernels that hold it longest,
    and the peak device memory the steps reached."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        step()
    windows, walls = [], []
    for _ in range(A9_TIMED_WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(A9_TIMED_STEPS):
            step()
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / A9_TIMED_STEPS)
        windows.append(start.elapsed_time(end) / A9_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(A9_PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in device) / 1e3
    busy_ms /= A9_PROFILED_STEPS
    top = sorted(device, key=lambda e: -float(getattr(e, "self_device_time_total", 0.0)))
    step_ms, wall_ms = float(np.median(windows)), float(np.median(walls))
    row = {
        "step": label, "batch": rows, "step_ms": step_ms, "step_ms_min": min(windows),
        "step_ms_max": max(windows), "rows_per_s": rows / step_ms * 1e3,
        "wall_ms_per_step_unprofiled": wall_ms,
        "device_kernels_per_step": sum(e.count for e in device) / A9_PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "peak_device_mib": peak / 2**20, "resident_before_mib": base / 2**20,
        # the kernels that hold the device longest: (name, ms a step, launches a step)
        "top_kernels": [(e.key[:80], float(e.self_device_time_total) / 1e3 / A9_PROFILED_STEPS,
                         e.count / A9_PROFILED_STEPS) for e in top[:8]],
    }
    log_timing("a9 step timing", row)
    return row


def _a9_step_timing(ft_args, path: str, train_ds) -> list[dict]:
    """The BERT-base pretraining step (``mlm_step`` at the job's batch,
    its host-drawn mask uploaded each step) and the fine-tune step
    (``train_step`` from the grafted state) on the card."""
    import numpy as np
    import torch

    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.train import loop, pretrain
    from mlops_tpu_torch.train.pipeline import load_init_state
    from mlops_tpu_torch.weights import load_params

    config = _job_config(ft_args, "cuda")
    data = _tensors(train_ds, "cuda")
    n, batch = data[0].shape[0], config.train.batch_size
    idx = torch.from_numpy(
        np.stack([loop.batch_indices(n, batch, 0, s) for s in range(1, 21)])).to("cuda")
    rows = []
    mlm = pretrain.build_mlm(config.model)
    load_params(mlm, pretrain.load_pretrained(path, config.model))
    mlm = mlm.to("cuda")
    opt = pretrain.make_adamw(mlm.parameters(), 3e-4)
    count = [0]

    def mlm_step():
        count[0] += 1
        i = idx[count[0] % 20]
        mask = torch.from_numpy(pretrain.step_mask(0, count[0], batch, mlm)).to("cuda")
        gen = loop.dropout_generator(0, count[0], torch.device("cuda"))
        pretrain.mlm_step(mlm, opt, data[0][i], data[1][i], mask, gen)

    rows.append(_a9_steps(mlm_step, "pretrain", batch))
    del mlm, opt
    torch.cuda.empty_cache()
    model = load_params(build_model(config.model), load_init_state(config)).to("cuda")
    opt = loop.make_optimizer(model, config.train)

    def fine_tune_step():
        count[0] += 1
        i = idx[count[0] % 20]
        loop.train_step(model, opt, config.train, count[0], *(t[i] for t in data))

    rows.append(_a9_steps(fine_tune_step, "fine_tune", batch))
    del model, opt
    torch.cuda.empty_cache()
    return rows


def _a9_serve_timing(bundles: dict) -> dict:
    """Each bundle on the card's exact tier: the warmup's graphs, capture
    seconds and graph pool bytes, and the dispatch -> fetch p50 at the
    four trained geometries."""
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    out = {}
    for name, path in bundles.items():
        bundle = load_bundle(path)
        engine = InferenceEngine(bundle, device="cuda")
        engine.warmup()
        stats = engine.warmup_stats
        row = {"model": name, "tier": engine.serve_tier, "programs": stats["programs"],
               "warmup_s": stats["warmup_s"], "capture_s": stats.get("capture_s"),
               "graph_pool_bytes": stats.get("graph_pool_bytes")}
        for s, b in EXACT_TRAINED_GEOMETRIES:
            row[f"dispatch_fetch_ms_p50_{s}x{b}"] = _dispatch_fetch_p50(
                engine, bundle.preprocessor, s, b, 380 + s + b, n=A9_P50_DISPATCHES)
        log_timing("a9 serve timing", row)
        out[name] = row
        del engine
        torch.cuda.empty_cache()
    return out


def _a9_check_and_serve(bundles: dict, device: str) -> tuple[dict, dict]:
    """Each bundle on the card against the CPU route at the four trained
    geometries (in a thread: the CPU route's products release the GIL)
    while ``serve`` on each answers the golden request; returns both
    worst prediction errors by name."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        parity = pool.submit(phase_exact_parity, bundles, device, EXACT_TRAINED_GEOMETRIES)
        http = _serve_golden(bundles, device)
        return parity.result()["max_pred_err"], http


def phase_a9(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """Phase 38: the moe family, masked-feature pretraining -> fine-tune
    at BERT-base width, and an ensemble of transformer members, through
    the entry points a user calls. ``train --config <job>
    model.family=moe`` (steps cut, with its bulk student) and ``pretrain
    --config <job>`` at BERT-base start at once; meanwhile in this
    process, the counts set to 0 just before, the moe on the card against
    the CPU (forward, auxiliary, gradients, routes), one stacked tune step
    of it at T = 2 card against CPU, and the ensemble bundle; then ``train
    ... train.init_params=<pretrained.msgpack>`` at BERT-base, its graft
    checked; the three bundles on the card against the CPU route at the
    four trained geometries and served over HTTP (the golden request),
    the moe's and the ensemble's while the fine-tune trains; then the
    pretrain and fine-tune steps and each bundle's dispatches
    timed on the card. No hand-written kernel runs on these paths: the
    counts read 0. ``extra`` and ``device="cpu"`` rehearse it small on the
    CPU."""
    import torch

    from mlops_tpu_torch.ops import quant_kernel

    root = WORK / "a9"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"a9: {what} at {time.perf_counter() - t0:.1f} s")

    moe_args = [*A9_MOE, f"train.steps={A9_MOE_STEPS}",
                f"train.eval_every={A9_MOE_EVAL_EVERY}", *extra]
    pre_args = [*BERT_BASE, *A9_PRETRAIN, *extra]
    log(f"a9: moe {' '.join(moe_args)}; pretrain {' '.join(pre_args)}; "
        f"fine-tune {' '.join(A9_FINETUNE)}; ensemble {' '.join(A9_ENSEMBLE)}")
    started = {"moe": _start_train_cli("moe", moe_args, root, device),
               "pretrain": _start_train_cli("pretrain", pre_args, root, device, "pretrain")}
    try:
        _reset_launch_counts()
        quant_kernel.quant_kernel_launches.reset()
        config = _job_config([*A9_MOE, *extra], device)
        train_ds, valid_ds = _exact_split(config)  # the job's data, as every run here reads it
        moe_parity = _a9_moe_parity(extra, device, train_ds)
        tune = _stack_parity(config.model, config.train, train_ds, valid_ds, device,
                             trials=A9_TUNE_TRIALS, steps=1)
        bundles = {"ft_ens4": _a9_ensemble_bundle(extra)}
        mark("moe card vs cpu, the T = 2 step and the ensemble bundle done")
        pretrained, pretrain_wall = _finish_pretrain_cli(started.pop("pretrain"))
        path = pretrained["pretrained"]
        ft_args = [*BERT_BASE, *A9_FINETUNE, f"train.init_params={path}", *extra]
        started["bert_base"] = _start_train_cli("bert_base", ft_args, root, device)
        mark("pretrain done, fine-tune started")
        graft = _a9_graft_check(ft_args, path, device)
        clis, walls = {}, {"pretrain": pretrain_wall}
        clis["moe"], walls["moe"] = _finish_train_cli(
            "moe", moe_args, started.pop("moe"), device)
        bundles["moe"] = Path(clis["moe"]["bundle"])
        mark("moe train done")
        # While the fine-tune trains: the moe and the ensemble bundles.
        parity, http = _a9_check_and_serve(bundles, device)
        mark("moe and ensemble bundles checked and served")
        clis["bert_base"], walls["bert_base"] = _finish_train_cli(
            "bert_base", ft_args, started.pop("bert_base"), device)
        mark("fine-tune done")
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    moe_manifest = json.loads((bundles["moe"] / "manifest.json").read_text())
    check(moe_manifest["model_config"]["family"] == "moe" and "bulk" in moe_manifest,
          "the moe bundle is not a moe bundle with its bulk student")
    bundles["bert_base"] = Path(clis["bert_base"]["bundle"])
    for got, more in zip((parity, http),
                         _a9_check_and_serve({"bert_base": bundles["bert_base"]}, device)):
        got.update(more)
    mark("BERT-base bundle checked and served")
    steps = serving = None
    if device == "cuda":
        torch.cuda.empty_cache()
        steps = _a9_step_timing(ft_args, path, train_ds)
        serving = _a9_serve_timing(bundles)
        mark("timings done")
    launches = (*_launch_counts(), quant_kernel.quant_kernel_launches.value)
    log(f"a9: kernel launches flash fwd/dq/dkv/quant_fused {launches}")
    check(launches == (0, 0, 0, 0), f"phase 38's paths launched kernels {launches}")
    cli = {name: {"steps": out["steps"], "packaged_step": out["packaged_step"],
                  "metrics": out["metrics"], "wall_s": walls[name]}
           for name, out in clis.items()}
    return {
        "moe": {"card_vs_cpu": moe_parity, "tune_step_T2": tune, "train": cli["moe"],
                "bulk_student": moe_manifest["bulk"]["model_config"],
                "bundle_parity": parity["moe"],
                "golden_http_max_pred_err": http["moe"],
                "serve_timing": (serving or {}).get("moe")},
        "pretrain": {"pretrain": {"rows": pretrained["rows"], "loss_curve": pretrained["loss_curve"],
                                  "wall_s": pretrain_wall},
                     "graft": graft, "fine_tune": cli["bert_base"], "step_timing": steps,
                     "bundle_parity": parity["bert_base"],
                     "golden_http_max_pred_err": http["bert_base"],
                     "serve_timing": (serving or {}).get("bert_base")},
        "transformer_ensemble": {"bundle_parity": parity["ft_ens4"],
                                 "golden_http_max_pred_err": http["ft_ens4"],
                                 "serve_timing": (serving or {}).get("ft_ens4")},
        "launches": launches,
        "bundles": {name: str(path) for name, path in bundles.items()},
    }


# Multi-rank training and scoring (ROADMAP A11a) at world size 1 over
# NCCL: the script runs on one H100, and NCCL refuses two ranks on one
# device. The mlp job (its 50,000 rows and batch 1,024) with
# model.tensor_parallel=1, steps cut; ft_transformer, bert and moe at the
# ModelConfig defaults (token_dim 64, depth 3, 8 heads: the only widths the
# repo defines); bert and ft_transformer with model.pipeline_stages=1,
# dropout 0 and the job's 8 microbatches.
A11_TP = ("model.tensor_parallel=1",)
A11_TP_STEPS = 200  # of the job's 2,000
A11_TP_EVAL_EVERY = 100
A11_CHECK_STEPS = 50  # held against the dense trainer, step by step
A11_FAMILIES = ("ft_transformer", "bert", "moe")
A11_PP_FAMILIES = ("bert", "ft_transformer")
A11_PP = ("model.pipeline_stages=1", "model.dropout=0", "train.distill_bulk=false")
A11_PP_STEPS = 50
A11_PP_EVAL_EVERY = 10
A11_CPU_STEPS = 5  # the same GPipe run on the CPU, held against the card's first
A11_TUNE = ("hpo.trials=2", "hpo.steps=30", "data.rows=10000")
A11_SCORE_ROWS = 100_000
A11_MESH_CHUNK = 65_536  # the in-process data-mesh sweeps: one full chunk and a tail
A11_TIMED_STEPS = 20
A11_AUC_TOL = 0.01  # card vs CPU validation AUC, PERF.md §2


def _launcher(args: list[str]) -> list[str]:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1
    -m mlops_tpu_torch <args>``: one rank, the launcher's environment."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "mlops_tpu_torch", *args]


def _a11_start(name: str, cmd: list[str], root: Path):
    root.mkdir(parents=True, exist_ok=True)
    log_path = root / f"{name}.log"
    err = open(log_path, "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                            stdout=subprocess.PIPE, stderr=err, text=True)
    return proc, err, log_path, time.perf_counter()


def _a11_finish(name: str, started) -> tuple[dict, float]:
    proc, err, log_path, t0 = started
    try:
        stdout, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"a11 {name} exited {proc.returncode}: {log_path.read_text()[-3000:]}")
    lines = [line for line in stdout.strip().splitlines() if line.startswith("{")]
    check(bool(lines), f"a11 {name} printed no JSON: {stdout[-2000:]}")
    out = json.loads(lines[-1])
    log(f"a11 {name}: {wall:.1f} s")
    return out, wall


def _a11_train_args(name: str, root: Path, args, device: str) -> list[str]:
    return ["train", "--config", EXACT_JOB_TOML, *args, f"registry.root={root / 'registry'}",
            f"registry.run_root={root / 'runs'}", f"registry.run_name={name}",
            f"train.device={device}"]


def _a11_layout_run(name: str, out: dict, steps: int, every: int, trained_with: str) -> list[dict]:
    """A layout trainer's JSON line against its metrics.jsonl: a row per
    window with a finite loss, the final step packaged, the bundle a
    calibrated flax bundle tagged with its layout."""
    check(set(out) == {"bundle", "model_uri", "run_dir", "steps", "packaged_step", "metrics"},
          f"a11 {name} printed keys {sorted(out)}")
    check(out["steps"] == steps and out["packaged_step"] == steps,
          f"a11 {name}: steps {out['steps']}, packaged {out['packaged_step']}")
    rows = [json.loads(line) for line in (Path(out["run_dir"]) / "metrics.jsonl").open()]
    check([r["step"] for r in rows] == list(range(every, steps + 1, every)),
          f"a11 {name} metrics.jsonl steps {[r['step'] for r in rows]}")
    check(all(math.isfinite(r["loss"]) for r in rows), f"a11 {name} losses {rows}")
    manifest = json.loads((Path(out["bundle"]) / "manifest.json").read_text())
    check(manifest["flavor"] == "flax" and manifest["calibration"]["temperature"] > 0
          and manifest["tags"]["trained_with"] == trained_with,
          f"a11 {name}: bundle {manifest['flavor']} tagged {manifest['tags']}")
    return rows


def _a11_tp_against_dense(config, train_ds, steps: int, device: str) -> dict:
    """The TP trainer (one rank, 'model' axis 1) and the dense trainer from
    the same init on the same batches and dropout streams: every loss and,
    after ``steps`` steps, every parameter, bit for bit."""
    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train.loop import batch_indices, make_optimizer, train_step
    from mlops_tpu_torch.train.tensor_parallel import make_tp_trainer

    tcfg = config.train
    dense_cfg = dataclasses.replace(config.model, tensor_parallel=0)
    dense = init_params(build_model(dense_cfg), tcfg.seed).to(device)
    opt = make_optimizer(dense, tcfg)
    tp = make_tp_trainer(config, device=device)
    cat, num, lab = _tensors(train_ds, device)
    losses_d, losses_t = [], []
    for step in range(1, steps + 1):
        idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, step)).to(device)
        losses_d.append(train_step(dense, opt, tcfg, step, cat[idx], num[idx], lab[idx]))
        losses_t.append(tp.step.step(step, cat[idx], num[idx], lab[idx]))
    ld, lt = torch.stack(losses_d).cpu(), torch.stack(losses_t).cpu()
    got = tp.step.gather(tp.step.params())
    want = {k: v.detach() for k, v in dense.named_parameters()}
    differ = sorted(k for k in want if not torch.equal(got[k], want[k]))
    param_err = max(float((got[k] - want[k]).abs().max()) for k in want)
    return {
        "family": dense_cfg.family, "steps": steps,
        "losses_bitwise": bool(torch.equal(ld, lt)),
        "max_loss_err": float((ld - lt).abs().max()),
        "params_bitwise": not differ, "params_differing": differ[:8],
        "max_param_err": param_err, "first_loss": float(ld[0]), "last_loss": float(ld[-1]),
    }


def _a11_pp_run(config, train_ds, valid_ds, steps: int, device: str, mesh, init,
                snapshot: int) -> dict:
    """The GPipe trainer (one stage, the job's microbatches) from ``init``
    on the job's batches: step 1's merged gradients, ``steps`` losses, and
    the validation AUC of the merged params after ``snapshot`` steps."""
    import torch

    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.train.loop import batch_indices, evaluate, training_loss
    from mlops_tpu_torch.train.pipeline_parallel import make_pp_train_step

    tcfg = config.train
    dense_cfg = dataclasses.replace(config.model, pipeline_stages=0)
    pp = make_pp_train_step(config.model, tcfg, mesh, seed=tcfg.seed, init_state=init,
                            device=device)
    cat, num, lab = _tensors(train_ds, device)
    vcat, vnum, vlab = _tensors(valid_ds, device)
    idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, 1)).to(device)
    rows = pp.local_rows(tcfg.batch_size)
    training_loss(pp.model, cat[idx][rows], num[idx][rows], lab[idx][rows], None,
                  tcfg.pos_weight).backward()
    grads = pp.dense_params({n: p.grad for n, p in pp.model.named_parameters()})
    pp.optimizer.zero_grad()
    losses, auc = [], None
    for step in range(1, steps + 1):
        idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, step)).to(device)
        losses.append(float(pp.step(step, cat[idx], num[idx], lab[idx])))
        if step == snapshot:
            auc = evaluate(build_model(dense_cfg).to(device), pp.dense_params(),
                           vcat, vnum, vlab)["validation_roc_auc_score"]
    return {"grads": grads, "losses": losses, "auc": auc}


def _a11_pp_against_dense(config, train_ds, valid_ds, steps: int, device: str) -> dict:
    """GPipe at one stage against the dense trainer from one init on the
    card (one step's gradients parameter by parameter: cosine and norm
    ratio; ``steps`` steps' loss curves), and the same GPipe run on the
    CPU (a gloo mesh beside the card's NCCL world) against the card's: its
    first ``A11_CPU_STEPS`` losses and the validation AUC there."""
    import torch

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.parallel.mesh import make_nd_mesh
    from mlops_tpu_torch.train.loop import (
        batch_indices, make_optimizer, train_step, training_loss)
    from mlops_tpu_torch.weights import load_params

    tcfg = config.train
    dense_cfg = dataclasses.replace(config.model, pipeline_stages=0)
    init = {k: v.clone() for k, v in init_params(build_model(dense_cfg), tcfg.seed).state_dict().items()}
    card = _a11_pp_run(config, train_ds, valid_ds, steps, device,
                       make_nd_mesh({"data": 1, "stage": 1}), init, A11_CPU_STEPS)
    cpu_cfg = dataclasses.replace(config, train=dataclasses.replace(tcfg, device="cpu"))
    cpu = _a11_pp_run(cpu_cfg, train_ds, valid_ds, A11_CPU_STEPS, "cpu",
                      make_nd_mesh({"data": 1, "stage": 1}, backend="gloo"), init, A11_CPU_STEPS)
    dense = load_params(build_model(dense_cfg), init).to(device)
    cat, num, lab = _tensors(train_ds, device)
    idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, 1)).to(device)
    training_loss(dense, cat[idx], num[idx], lab[idx], None, tcfg.pos_weight).backward()
    cos_min, ratio_worst = 1.0, 0.0
    for name, p in dense.named_parameters():
        a, b = p.grad.double().flatten(), card["grads"][name].double().flatten().to(device)
        if float(a.norm()) == 0.0 and float(b.norm()) == 0.0:
            continue
        cos_min = min(cos_min, float(a @ b / (a.norm() * b.norm())))
        ratio_worst = max(ratio_worst, abs(float(b.norm() / a.norm()) - 1.0))
    check(cos_min >= GRAD_COSINE_MIN and ratio_worst <= GRAD_NORM_RTOL,
          f"a11 pp {dense_cfg.family}: gradient cosine {cos_min:.4f}, norm gap {ratio_worst:.4f}")
    dense.zero_grad(set_to_none=True)
    opt = make_optimizer(dense, tcfg)
    ld = []
    for step in range(1, steps + 1):
        idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, step)).to(device)
        ld.append(float(train_step(dense, opt, tcfg, step, cat[idx], num[idx], lab[idx])))
    lp = card["losses"]
    gaps = [abs(a - b) for a, b in zip(ld, lp)]
    check(max(gaps) <= CURVE_MAX_GAP and sum(gaps) / len(gaps) <= CURVE_MEAN_GAP,
          f"a11 pp {dense_cfg.family}: curves apart by {max(gaps):.4f} max")
    if steps >= 40:
        check(sum(lp[-10:]) < sum(lp[:10]), f"a11 pp {dense_cfg.family}: loss did not fall {lp}")
    cpu_gaps = [abs(a - b) for a, b in zip(cpu["losses"], lp)]
    auc_gap = abs(cpu["auc"] - card["auc"])
    check(max(cpu_gaps) <= CURVE_MAX_GAP and auc_gap <= A11_AUC_TOL,
          f"a11 pp {dense_cfg.family}: CPU vs card losses {max(cpu_gaps):.4f} apart, AUC {auc_gap:.4f}")
    return {"family": dense_cfg.family, "grad_cosine_min": cos_min,
            "grad_norm_gap_max": ratio_worst, "curve_max_gap": max(gaps),
            "curve_mean_gap": sum(gaps) / len(gaps), "first_loss": lp[0], "last_loss": lp[-1],
            "cpu_vs_card": {"steps": len(cpu_gaps), "loss_gap_max": max(cpu_gaps),
                            "auc_card": card["auc"], "auc_cpu": cpu["auc"], "auc_gap": auc_gap}}


def _a11_data_mesh(bundle_dir: Path, device: str, root: Path) -> dict:
    """The data-mesh path of ``score-batch`` and the streamed scorer in
    this process, over the one-rank NCCL world: ``score_dataset`` and
    ``score_csv_stream`` with ``make_mesh()`` (each rank copies and scores
    its block of every chunk, the blocks gathered over 'data') against
    ``mesh=None`` on the same ``A11_SCORE_ROWS`` rows, bit for bit. The
    commands build a mesh only past one rank, as the JAX command does, so
    the launched runs take ``mesh=None``."""
    import numpy as np

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
    from mlops_tpu_torch.data.stream import score_csv_stream
    from mlops_tpu_torch.parallel import bulk
    from mlops_tpu_torch.parallel.mesh import make_mesh

    bundle = load_bundle(bundle_dir)
    columns, labels = generate_synthetic(A11_SCORE_ROWS, seed=11)
    ds = bundle.preprocessor.encode(columns)
    source = root / "mesh_rows.csv"
    write_csv_columns(source, columns, labels)
    mesh = make_mesh()
    # none, mesh, mesh, none: each side runs once first and once last.
    order = ("none", "mesh", "mesh", "none")
    sweeps, streams = [], []
    for i, name in enumerate(order):
        m = mesh if name == "mesh" else None
        sweeps.append(bulk.score_dataset(bundle, ds, chunk_rows=A11_MESH_CHUNK, device=device,
                                         mesh=m))
        streams.append(score_csv_stream(bundle, source, root / f"mesh_{i}.csv",
                                        chunk_rows=A11_MESH_CHUNK, device=device, mesh=m))
    want = sweeps[0]
    check(all(np.array_equal(got.predictions, want.predictions)
              and np.array_equal(got.outliers, want.outliers)
              and got.feature_drift == want.feature_drift for got in sweeps),
          "a11: score_dataset on a one-rank data mesh differs from mesh=None")
    scored = {(root / f"mesh_{i}.csv").read_bytes() for i in range(len(order))}
    check(len(scored) == 1 and all(st["rows"] == A11_SCORE_ROWS for st in streams),
          f"a11: score_csv_stream on a one-rank data mesh differs from mesh=None: {streams}")
    return {"rows": A11_SCORE_ROWS, "mesh": mesh.describe(), "path": want.path, "order": order,
            "sweep_rows_per_s": [r.rows_per_s for r in sweeps],
            "stream_rows_per_s": [st["rows_per_s"] for st in streams]}


def _a11_nccl_profile(config, train_ds, device: str) -> dict:
    """One TP step of the mlp job under ``torch.profiler``: the NCCL calls
    it made (the ``nccl:*`` host records ProcessGroupNCCL writes, all-reduces
    among them), the device kernels NCCL ran and the device-to-device
    copies (NCCL with one rank copies instead of launching a kernel);
    then step ms (CUDA events, the median of ``A11_TIMED_STEPS`` after
    warm-up) of the TP and the dense trainer."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train.loop import batch_indices, make_optimizer, train_step
    from mlops_tpu_torch.train.tensor_parallel import make_tp_trainer

    tcfg = config.train
    tp = make_tp_trainer(config, device=device)
    dense_cfg = dataclasses.replace(config.model, tensor_parallel=0)
    dense = init_params(build_model(dense_cfg), tcfg.seed).to(device)
    opt = make_optimizer(dense, tcfg)
    cat, num, lab = _tensors(train_ds, device)

    def batch(step):
        idx = torch.from_numpy(batch_indices(train_ds.n, tcfg.batch_size, tcfg.seed, step)).to(device)
        return cat[idx], num[idx], lab[idx]

    for step in range(1, 4):  # warm-up: allocator, cuBLAS handles, NCCL's communicator
        tp.step.step(step, *batch(step))
        train_step(dense, opt, tcfg, step, *batch(step))
    torch.cuda.synchronize()
    args = batch(4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp.step.step(4, *args)
        torch.cuda.synchronize()
    calls, nccl_kernels, copies = {}, {}, 0
    kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            if "nccl" in evt.name.lower():
                nccl_kernels[evt.name] = nccl_kernels.get(evt.name, 0) + 1
            if "dtod" in evt.name.lower().replace(" ", ""):
                copies += 1
        elif evt.name.startswith("nccl:"):
            calls[evt.name] = calls.get(evt.name, 0) + 1
    all_reduce = sum(n for name, n in calls.items() if "all_reduce" in name)

    def step_ms(fn) -> float:
        times = []
        for step in range(5, 5 + A11_TIMED_STEPS):
            b = batch(step)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(step, b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    tp_ms = step_ms(lambda step, b: tp.step.step(step, *b))
    dense_ms = step_ms(lambda step, b: train_step(dense, opt, tcfg, step, *b))
    n_params = len(list(dense.parameters()))
    row = {"kernels_per_step": kernels, "nccl_calls": sum(calls.values()),
           "all_reduces_per_step": all_reduce, "nccl_calls_by_name": calls,
           "nccl_kernels": sum(nccl_kernels.values()), "nccl_kernels_by_name": nccl_kernels,
           "device_to_device_copies": copies, "leaves": n_params,
           "tp_step_ms": tp_ms, "dense_step_ms": dense_ms}
    log_timing("a11 tp step", row)
    # The gradients were meaned over 'data' through NCCL: at least one
    # all-reduce ran, and every leaf came out of the step with a finite
    # gradient (however the means are bucketed).
    grads = [p.grad for p in tp.step.model.parameters()]
    check(all_reduce >= 1 and all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
          f"a11: {all_reduce} NCCL all-reduces in a TP step; "
          f"{sum(g is None for g in grads)} of {n_params} leaves without a gradient")
    return row


def phase_a11(extra: tuple[str, ...] = (), device: str = "cuda") -> dict:
    """Phase 39: multi-rank training and scoring at world size 1 over NCCL
    (ROADMAP A11a), through the entry points a user calls. Under
    ``torch.distributed.run --nproc-per-node 1``: ``train`` of the mlp job
    with ``model.tensor_parallel=1`` (steps cut), bert and ft_transformer
    with ``model.pipeline_stages=1``, and ``tune`` beside a plain
    ``tune``. Meanwhile in this process (a one-rank NCCL group from a
    local store, as a plain ``python -m mlops_tpu_torch`` makes), the
    counts set to 0 just before: the TP step of mlp, ft_transformer, bert
    and moe held bit for bit against the dense trainer over 50 steps and
    each trained through ``run_layout_training``; GPipe held against the
    dense trainer (gradients, curves) and the same GPipe run on the CPU
    against the card. Then every bundle served over HTTP (the golden
    request, the exact tier) while ``score-batch`` runs under the
    launcher beside a plain one, and in this process the data mesh of
    ``score_dataset`` and ``score_csv_stream`` (``make_mesh()`` over the
    one rank) held bit for bit against ``mesh=None``; last, one TP step
    profiled (its NCCL calls) and timed beside the dense step. No
    hand-written kernel runs here: the counts read 0."""
    import numpy as np

    from mlops_tpu_torch.ops import quant_kernel
    from mlops_tpu_torch.train.pipeline import run_layout_training

    root = WORK / "a11"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"a11: {what} at {time.perf_counter() - t0:.1f} s")

    tp_args = [*A11_TP, f"train.steps={A11_TP_STEPS}", f"train.eval_every={A11_TP_EVAL_EVERY}",
               *extra]
    started = {"tp_mlp": _a11_start(
        "tp_mlp", _launcher(_a11_train_args("tp_mlp", root, tp_args, device)), root)}
    for fam in A11_PP_FAMILIES:
        card = [f"model.family={fam}", *A11_PP, f"train.steps={A11_PP_STEPS}",
                f"train.eval_every={A11_PP_EVAL_EVERY}", *extra]
        started[f"pp_{fam}"] = _a11_start(
            f"pp_{fam}", _launcher(_a11_train_args(f"pp_{fam}", root, card, device)), root)
    tune_args = ["tune", "--config", EXACT_JOB_TOML, *A11_TUNE, *extra,
                 f"train.device={device}"]
    for name, wrap in (("tune_launcher", _launcher), ("tune_plain", _cli)):
        started[name] = _a11_start(name, wrap([*tune_args, f"registry.root={root / name / 'reg'}",
                                               f"registry.run_root={root / name / 'runs'}"]), root)
    score_started = {}
    try:
        _reset_launch_counts()
        quant_kernel.quant_kernel_launches.reset()
        config = _job_config([*A11_TP, *extra], device)
        train_ds, valid_ds = _exact_split(config)
        families, bundles = {}, {}
        for fam in ("mlp", *A11_FAMILIES):
            cfg = _job_config([*A11_TP, f"model.family={fam}", *extra], device)
            families[fam] = _a11_tp_against_dense(cfg, train_ds, A11_CHECK_STEPS, device)
            log(f"a11 tp {fam} vs dense: {json.dumps(families[fam])}")
            check(families[fam]["losses_bitwise"] and families[fam]["params_bitwise"],
                  f"a11: the {fam} TP step is not the dense step bit for bit")
            if fam == "mlp":
                continue  # its bundle comes from the launched job
            run_cfg = _job_config(
                [*A11_TP, f"model.family={fam}", f"train.steps={A11_CHECK_STEPS}",
                 f"train.eval_every={A11_CHECK_STEPS}", "train.distill_bulk=false",
                 f"registry.root={root / 'registry'}", f"registry.run_root={root / 'runs'}",
                 *extra], device)
            bundles[f"tp_{fam}"] = run_layout_training(run_cfg, run_name=f"tp_{fam}").bundle_dir
        mark("TP of every family against the dense trainer done")
        pp = {}
        for fam in A11_PP_FAMILIES:
            cfg = _job_config([f"model.family={fam}", *A11_PP, *extra], device)
            pp[fam] = _a11_pp_against_dense(cfg, train_ds, valid_ds, A11_PP_STEPS, device)
            log(f"a11 pp {fam} vs dense: {json.dumps(pp[fam])}")
        mark("PP against the dense trainer and card against CPU done")
        outs, walls = {}, {}
        outs["tp_mlp"], walls["tp_mlp"] = _a11_finish("tp_mlp", started.pop("tp_mlp"))
        bundles["tp_mlp"] = Path(outs["tp_mlp"]["bundle"])
        for name, wrap in (("launcher", _launcher), ("plain", _cli)):
            score_started[name] = _a11_start(f"score_{name}", wrap([
                "score-batch", f"serve.model_directory={bundles['tp_mlp']}",
                f"data.rows={A11_SCORE_ROWS}", f"score.output_path={root / f'score_{name}.npz'}",
                f"serve.device={device}", *extra]), root)
        for name in list(started):
            outs[name], walls[name] = _a11_finish(name, started.pop(name))
        mark("the launched trainings done")
        for fam in A11_PP_FAMILIES:
            bundles[f"pp_{fam}"] = Path(outs[f"pp_{fam}"]["bundle"])
        http = _serve_golden(bundles, device)
        mark("bundles served")
        data_mesh = _a11_data_mesh(bundles["tp_mlp"], device, root)
        log(f"a11 data mesh: {json.dumps(data_mesh)}")
        mark("the one-rank data mesh against mesh=None done")
        score = {name: _a11_finish(f"score_{name}", score_started.pop(name))[0]
                 for name in ("launcher", "plain")}
    finally:
        for proc, err, *_ in (*started.values(), *score_started.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            err.close()
    tp_rows = _a11_layout_run("tp_mlp", outs["tp_mlp"], A11_TP_STEPS, A11_TP_EVAL_EVERY,
                              "tensor_parallel dp1xtp1")
    for fam in A11_PP_FAMILIES:
        _a11_layout_run(f"pp_{fam}", outs[f"pp_{fam}"], A11_PP_STEPS, A11_PP_EVAL_EVERY,
                        "pipeline_parallel dp1xpp1")
    tune = {k: outs[f"tune_{k}"] for k in ("launcher", "plain")}
    keys = ("best_trial", "best_hyperparams", "metrics", "trials")
    check(all(tune["launcher"][k] == tune["plain"][k] for k in keys),
          f"a11: tune under the launcher {tune['launcher']} != plain {tune['plain']}")
    got, want = (np.load(root / f"score_{n}.npz") for n in ("launcher", "plain"))
    check(np.array_equal(got["predictions"], want["predictions"])
          and np.array_equal(got["outliers"], want["outliers"])
          and score["launcher"]["devices"] == score["plain"]["devices"] == 1
          and score["launcher"]["mesh"] == score["plain"]["mesh"] == [1],
          f"a11: score-batch under the launcher differs from plain: {score}")
    profile = _a11_nccl_profile(config, train_ds, device) if device == "cuda" else None
    launches = (*_launch_counts(), quant_kernel.quant_kernel_launches.value)
    log(f"a11: kernel launches flash fwd/dq/dkv/quant_fused {launches}")
    check(launches == (0, 0, 0, 0), f"phase 39's paths launched kernels {launches}")
    mark("done")
    return {
        "tp_vs_dense": families,
        "pp_vs_dense": pp,
        "nccl_step": profile,
        "tp_mlp_train": {"metrics": outs["tp_mlp"]["metrics"], "wall_s": walls["tp_mlp"],
                         "losses": [r["loss"] for r in tp_rows]},
        "pp_train": {fam: {"metrics": outs[f"pp_{fam}"]["metrics"], "wall_s": walls[f"pp_{fam}"]}
                     for fam in A11_PP_FAMILIES},
        "tune_walls": {k: walls[f"tune_{k}"] for k in ("launcher", "plain")},
        "score_rows_per_s": {k: v["rows_per_s"] for k, v in score.items()},
        "data_mesh": data_mesh,
        "golden_http_max_pred_err": http,
        "launches": launches,
        "wall_s": time.perf_counter() - t0,
    }


# Sharded serving (ROADMAP A11b, serve.model_shards) at S = 1 over NCCL: the
# script runs on one H100, and NCCL refuses two ranks on one device, so the
# sharded engine runs as a one-rank ('model',) mesh, its path and its
# collectives whole. Phase 38's BERT-base and moe bundles.
A11B_GEOMETRIES = ((1, 1), (1, 8), (1, 64), (1, 256), (64, 8))  # bitwise, sharded vs not
A11B_TIMED = ((1, 1), (1, 256), (64, 8))
A11B_REPLAYS = 20  # replays between two events, per timed geometry and turn
A11B_HTTP_REQUESTS = (1, 5, 40)  # records per POST /predict


class _ThreadPlane:
    """The single-process plane's ``HttpServer`` on ``engine`` (warmed),
    its event loop in a thread on a free port."""

    def __init__(self, engine) -> None:
        import asyncio

        from mlops_tpu_torch.config import ServeConfig
        from mlops_tpu_torch.serve.server import HttpServer

        self.port = _free_port()
        self.loop = asyncio.new_event_loop()
        server = HttpServer(engine, ServeConfig(host="127.0.0.1", port=self.port))
        self.srv = self.loop.run_until_complete(server.start())
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        import asyncio

        def shutdown():
            self.srv.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(shutdown)
        self.thread.join(timeout=30)
        pending = asyncio.all_tasks(self.loop)
        for task in pending:
            task.cancel()
        self.loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        self.loop.close()


def _row_cuts(bundle, mesh) -> int:
    """The collectives one forward of the bundle's model runs over
    ``mesh``, counted from its layout: one all-reduce per row-split Dense
    (a FFN's narrowing product, attention's out projection) and per split
    mixture of experts."""
    import copy

    from mlops_tpu_torch.models.layers import Dense
    from mlops_tpu_torch.models.moe import MoEFeedForward
    from mlops_tpu_torch.parallel.steps import shard_model

    model = copy.deepcopy(bundle.model)
    shard_model(model, mesh)
    return sum(1 for m in model.modules()
               if (isinstance(m, Dense) and m.tp is not None and m.tp.kind == "row")
               or (isinstance(m, MoEFeedForward) and m.tp is not None))


def _a11b_http(port: int, bodies: list[bytes]) -> list[bytes]:
    out = []
    for body in bodies:
        status, answer = _http(port, "POST", "/predict", body)
        check(status == 200, f"/predict answered {status}: {answer[:200]}")
        out.append(answer)
    return out


def _a11b_replay_ms(engine, key: tuple) -> float:
    """Device ms per replay of ``engine``'s graph at ``key`` (its inputs as
    the last dispatch left them), between two events on its stream."""
    import torch

    graph = engine._graphs[key]
    with torch.cuda.stream(engine._stream):
        for _ in range(5):
            graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(A11B_REPLAYS):
            graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / A11B_REPLAYS


def _a11b_profile(sharded) -> dict:
    """``torch.profiler`` on the sharded BERT-base engine: the host's NCCL
    records while one new bucket is captured (a replay makes its NCCL
    calls without the host), and the device ops of one replay."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        sharded.warm_grid((1, 3, 8, 64, 256))
    nccl = sum(e.count for e in prof.key_averages() if "nccl:all_reduce" in e.key)
    captured = sharded._graphs[("exact", (3,))].collectives
    check(nccl >= captured, f"the capture recorded {nccl} nccl:all_reduce calls, "
          f"the graph holds {captured}")
    with torch.profiler.profile(activities=activities) as prof:
        _dispatch_call(sharded, sharded.bundle.preprocessor, 1, 8, 7)()
        torch.cuda.synchronize()
    device_ops = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return {"capture_nccl_records": nccl, "capture_graph_collectives": captured,
            "replay_device_ops": sum(e.count for e in device_ops),
            "replay_nccl_kernels": sum(e.count for e in device_ops if "nccl" in e.key.lower())}


def phase_a11b(bundles: dict, device: str = "cuda") -> dict:
    """Phase 40: sharded serving (``serve.model_shards``) of phase 38's
    BERT-base and moe bundles over a one-rank ('model',) mesh over NCCL
    (``serve_mesh(1)``): the engine lays its params out by the partition
    rules and captures every program, NCCL calls inside, into its CUDA
    graphs. The counts set to 0 just before: each bundle's sharded engine
    against the unsharded engine bitwise at buckets 1, 8, 64, 256 and the
    64 x 8 group, every graph holding the collectives its layout implies
    and each replay counted with them, ``torch.profiler``'s host NCCL
    records at a capture; ``POST /predict`` to ``serve
    serve.model_shards=1`` in a subprocess and to the single-process
    plane's server on the sharded engine in process, byte for byte; then
    the sharded replay's device time against the unsharded graph's, in
    turns. No hand-written kernel runs here (BERT's tokens are below
    FLASH_MIN_SEQ): the four counts read 0."""
    import numpy as np
    import torch

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.ops import quant_kernel
    from mlops_tpu_torch.parallel import distributed
    from mlops_tpu_torch.parallel.collectives import COLLECTIVE_CALLS
    from mlops_tpu_torch.parallel.sharding import serve_mesh, sharded_axes
    from mlops_tpu_torch.parallel.steps import layout_specs
    from mlops_tpu_torch.serve.engine import InferenceEngine

    t0 = time.perf_counter()
    world = distributed.initialize(device)
    check(world.size == 1 and (device != "cuda" or world.backend == "nccl"),
          f"phase 40 needs a one-rank NCCL world, got {world}")
    mesh = serve_mesh(1, 0, device)
    bodies = [json.dumps(_records(n, 400 + n, drift=0.3)).encode() for n in A11B_HTTP_REQUESTS]
    port = _free_port()
    log_path = WORK / "a11b_server.log"
    server_log = open(log_path, "wb")
    cmd, _ = _serve_cmd(bundles["bert_base"], port, device)
    server = subprocess.Popen([*cmd, "serve.model_shards=1"], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)),
                              stdout=server_log, stderr=subprocess.STDOUT)
    out: dict = {"card": card_line() if device == "cuda" else "cpu", "families": {}}
    engines = {}
    try:
        _reset_launch_counts()
        quant_kernel.quant_kernel_launches.reset()
        COLLECTIVE_CALLS.reset()
        for name in ("bert_base", "moe"):
            bundle = load_bundle(bundles[name])
            prep = bundle.preprocessor
            sharded = InferenceEngine(bundle, device=device, mesh=mesh)
            sharded.warmup()
            # The unsharded engine captures the shapes it is asked for.
            plain = InferenceEngine(bundle, device=device)
            engines[name] = (plain, sharded)
            cuts = _row_cuts(bundle, mesh)
            per_graph = {f"{t}:{'x'.join(map(str, k))}": g.collectives
                         for (t, k), g in sharded._graphs.items()}
            check(cuts > 0 and (device != "cuda" or set(per_graph.values()) == {cuts}),
                  f"{name}: graphs hold {set(per_graph.values())} collectives, the layout {cuts}")
            before = COLLECTIVE_CALLS.value
            replays = 0
            for s, b in A11B_GEOMETRIES:
                got = _dispatch_call(sharded, prep, s, b, 410 + s + b)()
                want = _dispatch_call(plain, prep, s, b, 410 + s + b)()
                replays += 1
                for g, w in zip(got, want):
                    # An all-padding slot's drift is NaN on both sides.
                    check(np.array_equal(np.asarray(g), np.asarray(w), equal_nan=True),
                          f"{name}: sharded {s}x{b} is not bitwise the unsharded engine")
            check(COLLECTIVE_CALLS.value - before == replays * cuts,
                  f"{name}: {COLLECTIVE_CALLS.value - before} NCCL calls over {replays} replays")
            check(sharded.monitor_snapshot() == plain.monitor_snapshot(),
                  f"{name}: the sharded engine's monitor aggregate differs")
            # The memory sharding buys, computed from the specs (not
            # measured): each card's blocks of the committed params.
            params = sharded._tiers["exact"].params
            bytes_per_card = {}
            for shards in (1, 2, 4):
                specs = layout_specs(bundle.model, {"model": shards})
                bytes_per_card[shards] = sum(
                    p.numel() * p.element_size() // shards ** len(sharded_axes(specs[k]))
                    for k, p in params.items())
            out["families"][name] = {
                "nccl_calls_per_replay": cuts, "graphs": len(per_graph),
                "split_params": sum(1 for v in sharded._tiers["exact"].specs.values() if any(v)),
                "param_bytes_per_card_computed": bytes_per_card,
                "warmup": sharded.warmup_stats,
            }
            log(f"a11b: {name} sharded at S = 1 bitwise at {A11B_GEOMETRIES}; "
                f"{len(per_graph)} graphs x {cuts} NCCL calls")
        sharded = engines["bert_base"][1]
        if device == "cuda":
            out.update(_a11b_profile(sharded))
        # HTTP: serve serve.model_shards=1 (no mesh) and the sharded engine
        # behind the single-process plane's server, the same bytes.
        deadline = time.monotonic() + 300
        while True:
            check(server.poll() is None, f"serve exited early: {log_path.read_text()[-2000:]}")
            try:
                if _http(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "serve serve.model_shards=1 never became ready")
            time.sleep(0.5)
        unsharded_http = _a11b_http(port, bodies)
        plane = _ThreadPlane(sharded)
        try:
            sharded_http = _a11b_http(plane.port, bodies)
        finally:
            plane.stop()
        check(sharded_http == unsharded_http,
              "the sharded engine's /predict bytes differ from serve serve.model_shards=1's")
        server.send_signal(signal.SIGTERM)
        check(server.wait(timeout=120) == 0, "serve did not exit 0 after SIGTERM")
        launches = (*_launch_counts(), quant_kernel.quant_kernel_launches.value)
        check(launches == (0, 0, 0, 0), f"phase 40's paths launched kernels {launches}")
        out["http_requests"] = len(bodies)
        out["launches"] = launches
        if device == "cuda":
            timing = {}
            for name, (plain, sharded) in engines.items():
                for s, b in A11B_TIMED:
                    key = ("exact", (b,) if s == 1 else (s, b))
                    turns = [_a11b_replay_ms(e, key) for e in (plain, sharded, sharded, plain)]
                    row = {"model": name, "shape": f"{s}x{b}",
                           "unsharded_ms": (turns[0] + turns[3]) / 2,
                           "sharded_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
                    log_timing("a11b replay", row)
                    timing[f"{name} {s}x{b}"] = row
            out["replay_timing"] = timing
    finally:
        if server.poll() is None:
            server.kill()
            server.wait(timeout=30)
        server_log.close()
        engines.clear()
        if device == "cuda":
            torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _a11b_seeded_bundles(seed: int = 0, extra: tuple[str, ...] = ()) -> dict:
    """Phase 38's two bundles' architectures (the job's config at
    BERT-base and ``model.family=moe``) at seeded weights, for phase 40
    alone (``--a11b``): the preprocessor and monitor fitted on 20,000
    synthetic rows."""
    from mlops_tpu_torch.bundle import save_exact_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.monitor.state import fit_monitor

    columns, _ = generate_synthetic(20000, seed=seed)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=2048)
    out = {}
    for k, (name, args) in enumerate((("bert_base", BERT_BASE), ("moe", A9_MOE))):
        config = _job_config([*args, *extra], "cpu").model
        model = build_model(config)
        _seeded_exact_params(model, seed + k)
        directory = WORK / f"a11b_{name}"
        shutil.rmtree(directory, ignore_errors=True)
        save_exact_bundle(directory, config, model.eval(), prep, monitor,
                          calibration={"temperature": 1.2},
                          tags={"source": "chip_smoke.py", "note": "seeded weights, not trained"})
        out[name] = directory
    return out


def a11b_main() -> int:
    """``chip_smoke.py --a11b``: phases 1 and 40 alone, on seeded bundles
    of phase 38's architectures (a quick look at sharded serving on the
    card)."""
    _setup()
    _no_tf32()
    try:
        timed(phase_card)
        out = timed(phase_a11b, timed(_a11b_seeded_bundles))
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


def a11_main() -> int:
    """``chip_smoke.py --a11``: phases 1 and 39 alone (a quick look at
    the multi-rank paths on the card)."""
    _setup()
    try:
        timed(phase_card)
        out = timed(phase_a11)
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


RING_PHASES_FLAG = "--ring-phases"


def _setup() -> None:
    sys.path.insert(0, str(ROOT))
    WORK.mkdir(parents=True, exist_ok=True)
    # Bytecode goes to a cache in the work directory, for this process and
    # every subprocess it starts: where the interpreter's site-packages
    # cannot be written, each process would otherwise compile torch's
    # modules anew (about 7 s), and the CLI walls would time that.
    sys.pycache_prefix = str(WORK / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix


# Phase 41: the tooling. Geometries (slots x rows) ``checked`` runs the
# packed programs at; the NaN is planted at one of them.
TOOLING_GEOMETRIES = ((1, 1), (1, 256), (64, 8))
TOOLING_REPS = 5  # timed calls per program and geometry, each way
TOOLING_FLOP_ROWS = 256  # the mlp-ens8 forward FlopCounterMode counts


def phase_tooling(bundle_dir: Path, device: str = "cuda") -> dict:
    """Phase 41: the port's tooling on the card. (a) ``analyze --strict
    --concurrency --contracts --async --fail-stale --no-trace`` over the
    package in a subprocess (exit 0, timed), then Layer 2 in this process
    with every entry on fake ``device`` tensors: no finding, and every
    launch counter unchanged across the trace run; ``analyze --numeric``
    in a subprocess, whose audit must run clean on the card. (b) ``utils/
    debug.checked`` around the quant and exact tiers' packed programs of
    phase 22's bundle at 1x1, 1x256 and 64x8: outputs bitwise the
    unchecked call's, ``quant_fused`` launched inside the checked call, a
    NaN planted in one numeric raising an error naming the op or kernel
    (and, unchecked, coming out of ``quant_fused`` as NaN where its plain
    version's does), and the ms ``checked`` adds. (c) ``utils/flops``: ``peak_flops`` for the
    card's name, ``measured_gemm_peak`` (bf16) as a share of it, and the
    ``FlopCounterMode`` count of the mlp-ens8 forward against its analytic
    2*M*N*K."""
    import statistics

    import numpy as np
    import torch

    import mlops_tpu_torch.ops.attention  # noqa: F401  (every launch counter exists
    import mlops_tpu_torch.ops.gbm_tensor  # noqa: F401   before the trace run)
    import mlops_tpu_torch.parallel.collectives  # noqa: F401
    from mlops_tpu_torch.analysis.traces import run_trace_checks
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data import generate_synthetic
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.cuda_build import LAUNCH_COUNTERS
    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
    )
    from mlops_tpu_torch.ops.quant_kernel import (
        fused_core_cuda,
        fused_core_reference,
        make_quant_grouped_base,
        make_quant_packed_base,
        quant_kernel_launches,
    )
    from mlops_tpu_torch.utils import flops
    from mlops_tpu_torch.utils.debug import NumericCheckError, checked

    result: dict = {}
    # (a) the gate on this machine, then Layer 2 on the card's fakes.
    t0 = time.perf_counter()
    gate = subprocess.run(
        _cli(["analyze", "--strict", "--concurrency", "--contracts", "--async",
              "--fail-stale", "--no-trace", "mlops_tpu_torch/"]),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    gate_s = time.perf_counter() - t0
    check(gate.returncode == 0, f"analyze exited {gate.returncode}: {gate.stdout[-3000:]}")
    before = {c.name: c.value for c in LAUNCH_COUNTERS}
    t0 = time.perf_counter()
    findings, notes = run_trace_checks(device=device)
    layer2_s = time.perf_counter() - t0
    after = {c.name: c.value for c in LAUNCH_COUNTERS}
    check(not findings, "Layer 2 on the card: " + "; ".join(f.format() for f in findings))
    check(after == before, f"launch counters moved across Layer 2: {before} -> {after}")
    # The numeric audit as a user runs it: the CLI picks the card itself.
    t0 = time.perf_counter()
    audit = subprocess.run(
        _cli(["analyze", "--strict", "--no-trace", "--numeric",
              "mlops_tpu_torch/analysis/entrypoints.py"]),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    audit_s = time.perf_counter() - t0
    audit_notes = [line for line in audit.stdout.splitlines()
                   if line.startswith("tpulint: numeric audit")]
    check(audit.returncode == 0 and len(audit_notes) == 2 and all(
        f"numeric audit on {device}:" in line and "clean" in line for line in audit_notes),
        f"analyze --numeric exited {audit.returncode}: {audit.stdout[-3000:]}")
    result["analyze"] = {"gate_no_trace_s": gate_s, "gate_summary": gate.stdout.strip().splitlines()[-1],
                         "layer2_s": layer2_s, "layer2_device": device,
                         "traced": [n for n in notes if n.startswith(("traced", "skipped"))],
                         "launch_counters": before, "numeric_audit_s": audit_s,
                         "numeric_audit": audit_notes}
    log_timing("tooling analyze", result["analyze"])

    # (b) checked around the packed programs.
    bundle = load_bundle(bundle_dir)
    dev = torch.device(device)
    columns, _ = generate_synthetic(max(s * r for s, r in TOOLING_GEOMETRIES), seed=41)
    ds = bundle.preprocessor.encode(columns)
    monitor = bundle.monitor.to(dev)
    temp = torch.ones((), dtype=torch.float32, device=dev)
    model = bundle.model.eval()
    tiers = {
        "quant": ({k: v.to(dev) for k, v in bundle.quant_params.items()},
                  make_quant_packed_base(), make_quant_grouped_base()),
        "exact": ({k: v.to(dev) for k, v in model_params(model).items()},
                  make_packed_predict_base(model), make_packed_grouped_base(model)),
    }

    def inputs(s, r):
        cat = torch.from_numpy(ds.cat_ids[: s * r].astype(np.int32)).to(dev)
        num = torch.from_numpy(ds.numeric[: s * r].astype(np.float32)).to(dev)
        mask = torch.ones((s, r), dtype=torch.bool, device=dev)
        if s == 1:
            return cat, num, mask[0]
        return cat.reshape(s, r, -1), num.reshape(s, r, -1), mask

    def timed_ms(fn, args):
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
        walls = []
        for _ in range(TOOLING_REPS):
            sync(dev)
            t0 = time.perf_counter()
            fn(*args)
            sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    rows = []
    for tier, (params, solo, grouped) in tiers.items():
        for s, r in TOOLING_GEOMETRIES:
            program = solo if s == 1 else grouped
            cat, num, mask = inputs(s, r)
            args = (params, monitor, init_accumulator(dev), temp, cat, num, mask)
            plain_out = program(*args)
            launches = quant_kernel_launches.value
            checked_out = checked(program)(*args)
            launched = quant_kernel_launches.value - launches
            check(torch.equal(plain_out[0], checked_out[0]) and all(
                torch.equal(getattr(plain_out[1], f), getattr(checked_out[1], f))
                for f in ("rows", "outliers", "batches", "drift_sum", "drift_last")),
                f"checked {tier} {s}x{r}: not bitwise the unchecked output")
            if tier == "quant" and device == "cuda":
                check(launched >= 1, f"checked quant {s}x{r}: quant_fused did not launch")
            bad = num.clone()
            bad.view(-1)[3] = float("nan")
            try:
                checked(program)(params, monitor, init_accumulator(dev), temp, cat, bad, mask)
            except NumericCheckError as err:
                named = err.op
            else:
                raise SmokeFailure(f"checked {tier} {s}x{r}: a planted NaN raised nothing")
            if tier == "quant" and device == "cuda":
                # Unchecked, the kernel keeps the NaN as its plain version
                # does: NaN in the same predictions, the rest equal.
                core = (params["embed"], params["w1_q"], params["w1_s"], params["b1"],
                        params["w2_q"], params["w2_s"], params["b2"],
                        monitor.num_ref_sorted, monitor.num_ref_cdf, monitor.out_mean,
                        monitor.out_precision, monitor.out_threshold, temp,
                        cat.reshape(s, r, -1), bad.reshape(s, r, -1), mask.reshape(s, r))
                kp, _, kc, kk = fused_core_cuda(*core)
                rp, _, rc, rk = fused_core_reference(*core)
                check(bool(kp[0, 0].isnan()) and torch.equal(kp.isnan(), rp.isnan())
                      and torch.equal(kc, rc) and torch.equal(kk.nan_to_num(), rk.nan_to_num())
                      and float((kp - rp).nan_to_num().abs().max()) <= 1e-6,
                      f"quant_fused {s}x{r} on a planted NaN: {kp[0, :4].tolist()} "
                      f"against the plain version's {rp[0, :4].tolist()}")
            plain_ms = timed_ms(program, args)
            checked_ms = timed_ms(checked(program), args)
            row = {"tier": tier, "geometry": f"{s}x{r}", "bitwise": True,
                   "quant_fused_launches": launched, "nan_named": named,
                   "unchecked_ms": plain_ms, "checked_ms": checked_ms,
                   "checked_adds_ms": checked_ms - plain_ms}
            log_timing("tooling checked", row)
            rows.append(row)
    result["checked"] = rows

    # (c) the card's peaks and a FLOP count.
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    peaks = {dt: flops.peak_flops(name, dt) for dt in ("bf16", "tf32", "f32", "fp8")}
    gemm = flops.measured_gemm_peak(dtype="bf16") if device == "cuda" else None
    cat, num, _ = inputs(1, TOOLING_FLOP_ROWS)
    counted = flops.compiled_flops(
        lambda c, n: torch.func.functional_call(model, tiers["exact"][0], (c, n)), cat, num)
    analytic = sum(2 * TOOLING_FLOP_ROWS * math.prod(p.shape)
                   for k, p in model.named_parameters() if k.endswith("kernel"))
    check(counted == analytic, f"FlopCounterMode {counted} != analytic {analytic}")
    result["flops"] = {
        "device_name": name, "part": flops.h100_part(name), "peak_flops": peaks,
        "hbm_bytes_per_s": flops.peak_bytes_per_s(name),
        "measured_gemm_bf16_flops": gemm,
        "gemm_share_of_peak": gemm / peaks["bf16"] if gemm and peaks["bf16"] else None,
        "mlp_ens8_forward_rows": TOOLING_FLOP_ROWS, "flop_counter": counted,
        "analytic_2mnk": analytic,
    }
    log_timing("tooling flops", result["flops"])
    return result


def _ring_phases(burst_dir: Path, exact_dirs: dict) -> dict:
    """Phases 29-37, 39 and 41, in order: each needs only the bundles of
    phases 16 and 22 (phase 37 its fixture, phase 39 nothing) and the
    card, and writes under its own work directory."""
    return {
        "ring": timed(phase_ring, burst_dir),
        "lifecycle": timed(phase_lifecycle, burst_dir),
        "ring_lifecycle": timed(phase_ring_lifecycle, burst_dir),
        "chaos": timed(phase_chaos, burst_dir),
        "replicas": timed(phase_replicas, burst_dir),
        "tenants": timed(phase_tenants, burst_dir, exact_dirs),
        "observability": timed(phase_observability, burst_dir),
        "autotune": timed(phase_autotune, burst_dir),
        "gbm": timed(phase_gbm),
        "a11": timed(phase_a11),
        "tooling": timed(phase_tooling, burst_dir),
    }


def _stop_on_sigterm(signum, frame):
    raise SmokeFailure("stopped by SIGTERM")


def ring_phases_main(spec_path: str, out_path: str) -> int:
    """The second process: phases 29-37, 39 and 41 on the bundles ``spec_path``
    names; their results go to ``out_path`` as JSON. SIGTERM fails the
    phase under way, so its planes are stopped on the way out."""
    signal.signal(signal.SIGTERM, _stop_on_sigterm)
    _setup()
    _no_tf32()
    spec = json.loads(Path(spec_path).read_text())
    try:
        results = _ring_phases(Path(spec["burst_dir"]),
                               {k: Path(v) for k, v in spec["exact_dirs"].items()})
    except SmokeFailure as err:
        print(f"chip_smoke FAILED (phases 29-37, 39, 41): {err}", file=sys.stderr, flush=True)
        return 1
    Path(out_path).write_text(json.dumps(results, default=str))
    return 0


class _RingSide:
    """Phases 29-37, 39 and 41 in a second process of this script, started beside
    phases 16-28; ``join`` returns their results, ``check`` fails the run
    as soon as that process failed, ``stop`` ends it and its planes."""

    def __init__(self, burst_dir: Path, exact_dirs: dict) -> None:
        spec = WORK / "ring_phases_spec.json"
        self.out = WORK / "ring_phases.json"
        self.out.unlink(missing_ok=True)
        spec.write_text(json.dumps({"burst_dir": str(burst_dir),
                                    "exact_dirs": {k: str(v) for k, v in exact_dirs.items()}}))
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), RING_PHASES_FLAG,
             str(spec), str(self.out)], cwd=ROOT)
        log(f"phases 29-37, 39 and 41 started in process {self.proc.pid}")

    def check(self) -> None:
        code = self.proc.poll()
        check(code in (None, 0), f"phases 29-37, 39, 41 failed (exit {code}; see above)")

    def join(self) -> dict:
        t0 = time.perf_counter()
        code = self.proc.wait()
        log(f"waited {time.perf_counter() - t0:.1f} s for phases 29-37, 39 and 41")
        check(code == 0, f"phases 29-37, 39, 41 failed (exit {code}; see above)")
        return json.loads(self.out.read_text())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def main() -> int:
    if not (ROOT / "mlops_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(mlops_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    _setup()
    t0 = time.perf_counter()
    side = None

    def beside(phase, *args):
        """A phase of 16-28, then a look at the second process."""
        out = timed(phase, *args)
        side.check()
        return out

    try:
        timed(phase_card)
        timed(phase_build)
        bundle_dir = timed(phase_bundle)
        parity = timed(phase_parity, bundle_dir)
        served = timed(phase_serve, bundle_dir)
        timing = timed(phase_timing, bundle_dir, served["engine"])
        flash = timed(phase_flash_parity)
        doc_dir, history = timed(phase_doc_bundle)
        doc = timed(phase_doc_path, doc_dir, history)
        flash_timing = timed(phase_flash_timing, doc_dir)
        bwd = timed(phase_bwd_parity)
        train_parity = timed(phase_train_parity)
        trained = timed(phase_train_path, history)
        train_timing = timed(phase_train_timing)
        c1_train = timed(phase_c1_train)
        c1_timing = timed(phase_c1_timing)
        c2 = timed(phase_c2, bundle_dir)
        exact_dirs = timed(phase_exact_bundles)
        burst_dir = timed(phase_burst_bundle, exact_dirs)
        side = _RingSide(burst_dir, exact_dirs)
        exact_parity = beside(phase_exact_parity, exact_dirs)
        exact = beside(phase_exact_serve, exact_dirs)
        exact_timing = beside(phase_exact_timing, exact_dirs)
        exact_train_parity = beside(phase_exact_train_parity)
        exact_train = beside(phase_exact_train_path)
        exact_train_timing = beside(
            phase_exact_train_timing,
            {name: row["wall_s"] for name, row in exact_train["cli"].items()})
        routes = beside(phase_dispatch_routes, bundle_dir, exact_dirs)
        burst = beside(phase_burst, burst_dir)
        students = beside(phase_students)
        bulk_rows = beside(phase_bulk, students)
        streamed = beside(phase_stream, students)
        tune_job = beside(phase_tune_job)
        tune_arch = beside(phase_tune_arch)
        deployed = beside(phase_deployed_job, tune_job["cli"])
        a9 = beside(phase_a9)
        a11b = beside(phase_a11b, a9["bundles"])
        ring_side = side.join()
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1
    finally:
        if side is not None:
            side.stop()
    (ring, lifecycle, ring_lifecycle, chaos, replicas, tenants, observability, autotune, gbm,
     a11, tooling) = (
        ring_side[k] for k in ("ring", "lifecycle", "ring_lifecycle", "chaos", "replicas",
                               "tenants", "observability", "autotune", "gbm", "a11",
                               "tooling"))
    import torch

    from mlops_tpu_torch.ops import attention
    from mlops_tpu_torch.ops.quant_kernel import REPLACES

    check_launches = served["launches"]
    if check_launches < 1:
        print("chip_smoke FAILED: quant_fused never launched on the main path",
              file=sys.stderr)
        return 1
    head = timing[0]  # bucket 1: the golden request's shape
    train_fwd, train_dq, train_dkv = trained["launches"]
    bwd_common = {
        "route": "cuda",
        "source": "mlops_tpu_torch/csrc/flash_attention_bwd.cu",
        "plain_ms": train_timing["plain_ms"],  # the plain version computes the pair
        "library_ms": train_timing["library_ms"],  # SDPA's backward: the pair
        "shape": train_timing["shape"],
        "parity": bwd["cases"],
    }
    kernels = {
        "kernels": [{
            "name": "quant_fused",
            "route": "cuda",
            "source": "mlops_tpu_torch/csrc/quant_fused.cu",
            "replaces": REPLACES,
            "launches": check_launches,
            "max_abs_err": parity["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "profiler_ms": head["profiler_ms"],
            "host_paced_ms": head["host_paced_ms"],
            "empty_launch_ms": head["empty_launch_ms"],
            "shape": head["shape"],
            "timings": timing,
            "large_shapes": c2,
            "trained_tier_launches": students["launches"],
            "ring_launches": ring["launches"],
            "lifecycle_launches": lifecycle["launches"],
            "ring_lifecycle_launches": {
                **{k: v["quant_fused_launches"]
                   for k, v in ring_lifecycle["windows"].items()},
                "after_respawn": ring_lifecycle["kill"]["quant_fused_launches_after_respawn"]},
            "replica_set_launches": replicas["launches"],
            "tenant_fleet_launches": {
                "single_probe": tenants["single_probe_launches"],
                "ring_probe": tenants["ring_probe_launches"],
                "ring_quota": tenants["quota_launches"]},
            "observability_launches": observability["launches"],
            "autotune_launches": autotune["launches"],
            # Phase 41: launches inside utils/debug.checked calls.
            "tooling_checked_launches": sum(
                row["quant_fused_launches"] for row in tooling["checked"]),
        }, {
            "name": "flash_attention",
            "route": "cuda",
            "source": "mlops_tpu_torch/csrc/flash_attention.cu",
            "replaces": attention.REPLACES,
            "launches": doc["launches"],
            "train_launches": train_fwd,
            "max_abs_err": flash["max_abs_err"],
            "ms": flash_timing["ms"],
            "plain_ms": flash_timing["plain_ms"],
            "bound_ms": flash_timing["bound_ms"],
            "bound_by": flash_timing["bound_by"],
            "library_ms": flash_timing["library_ms"],
            "shape": flash_timing["shape"],
            "timing": flash_timing,
            "parity": flash["cases"],
            "doc_path": doc,
            "head_dims": {d: {k: v for k, v in row.items() if k.startswith("fwd_")}
                          for d, row in c1_timing.items()},
            "c1_train_launches": {d: row["launches_fwd_dq_dkv"][0]
                                  for d, row in c1_train.items()},
        }, {
            "name": "flash_bwd_dq",
            "replaces": attention.BWD_DQ_REPLACES,
            "launches": train_dq,
            "max_abs_err": bwd["dq_err"],
            "ms": train_timing["dq_ms"],
            "bound_ms": train_timing["dq_bound_ms"],
            "bound_by": train_timing["dq_bound_by"],
            "head_dims": {d: {k: v for k, v in row.items()
                              if k.startswith(("dq_", "bwd_"))}
                          for d, row in c1_timing.items()},
            "c1_train_launches": {d: row["launches_fwd_dq_dkv"][1]
                                  for d, row in c1_train.items()},
            **bwd_common,
        }, {
            "name": "flash_bwd_dkv",
            "replaces": attention.BWD_DKV_REPLACES,
            "launches": train_dkv,
            "max_abs_err": bwd["dkv_err"],
            "ms": train_timing["dkv_ms"],
            "bound_ms": train_timing["dkv_bound_ms"],
            "bound_by": train_timing["dkv_bound_by"],
            "head_dims": {d: {k: v for k, v in row.items()
                              if k.startswith(("dkv_", "bwd_"))}
                          for d, row in c1_timing.items()},
            "c1_train_launches": {d: row["launches_fwd_dq_dkv"][2]
                                  for d, row in c1_train.items()},
            **bwd_common,
        }],
        # The gbm tier runs no hand-written kernel (its JAX program is jnp):
        # its count is the graph replays of its dispatches in phase 37.
        "gbm_graph_replays": gbm["replays"],
        "gbm_tier": {k: v for k, v in gbm.items() if k != "replays"},
        # Phase 38's paths run no hand-written kernel (the JAX package runs
        # them in jnp): their launches of the four kernels read 0.
        "a9_launches": a9["launches"],
        "moe": a9["moe"],
        "pretrain": a9["pretrain"],
        "transformer_ensemble": a9["transformer_ensemble"],
        # Phase 39's paths (multi-rank training and scoring at world size
        # 1 over NCCL) run no hand-written kernel either.
        "a11_launches": a11["launches"],
        "a11": {k: v for k, v in a11.items() if k != "launches"},
        # Phase 40's paths (sharded serving over a one-rank NCCL mesh) run
        # no hand-written kernel either: NCCL calls in its graphs instead.
        "a11b_launches": a11b["launches"],
        "a11b": {k: v for k, v in a11b.items() if k != "launches"},
        # Phase 41: the analyzer, checked and the card's peaks.
        "tooling": tooling,
        "exact": {"parity": exact_parity, "serve": exact, "timing": exact_timing},
        "serving": {"dispatch_routes": routes, "burst": burst, "ring": ring},
        "lifecycle": {k: v for k, v in lifecycle.items() if k != "launches"},
        "ring_lifecycle": ring_lifecycle,
        "chaos": chaos,
        "replica_set": replicas,
        "tenant_fleet": tenants,
        "observability": {k: v for k, v in observability.items() if k != "launches"},
        "autotune": {k: v for k, v in autotune.items() if k != "launches"},
        "students": {"records": students["records"], "fit": students["fit"],
                     "served_quant_bundle": students["quant_bundle"]},
        "bulk": bulk_rows,
        "stream": streamed,
        "tune": {"job": tune_job, "arch": tune_arch, "deployed": deployed},
        "exact_train": {
            "parity": exact_train_parity,
            "path": exact_train,
            "timing": exact_train_timing,
        },
        "train": {
            "parity": train_parity,
            "timing": train_timing,
            "metrics": trained["cli"]["metrics"],
        },
    }
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == RING_PHASES_FLAG:
        sys.exit(ring_phases_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:] == ["--a11"]:
        sys.exit(a11_main())
    if sys.argv[1:] == ["--a11b"]:
        sys.exit(a11b_main())
    sys.exit(main())
