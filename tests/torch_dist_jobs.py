"""The jobs a multi-rank test group runs (``tests/torch_dist.py``): each
takes the inputs the test process wrote (numpy arrays, plain values) and
the group's work directory, runs on every rank of the gloo group, and
returns what rank 0 hands back (whole arrays, gathered over the meshes'
axes). Torch and the port only: no JAX here.

A mesh is built by every rank of the world (``torch.distributed.new_group``
needs them all); a rank outside it skips the work. Meshes over the first
``n`` ranks stand for the JAX tests' ``make_nd_mesh(..., devices=
jax.devices()[:n])``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mlops_tpu_torch.parallel.collectives import all_gather_cat, all_reduce_sum
from mlops_tpu_torch.parallel.mesh import make_mesh, make_nd_mesh

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _block(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n, i = mesh.size(axis), mesh.index(axis)
    b = x.shape[dim] // n
    return x.detach().narrow(dim, i * b, b).contiguous()


def _whole(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    if axis not in mesh.axis_names:
        return x
    return all_gather_cat(x.detach().contiguous(), dim, mesh.group(axis))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _configs(inputs: dict, family: str, **overrides):
    from mlops_tpu_torch.config import Config, ModelConfig, TrainConfig

    config = Config()
    config.model = ModelConfig(**{**inputs["models"][family], **overrides.pop("model", {})})
    config.train = TrainConfig(**{**inputs["train"], **overrides.pop("train", {})})
    return config


# ------------------------------------------------------------ collectives
@job
def collectives(inputs: dict, workdir: Path) -> dict:
    """The port's ``pmean``, ``gather`` and ``ring_shift_on`` over 'data'
    (the JAX ``pmean_over_data``, ``all_gather_rows`` and ``ring_shift``)
    with their gradients, on 'data' meshes of 2 and 4 ranks."""
    from mlops_tpu_torch.parallel.collectives import gather, pmean, ring_shift_on

    x, w = _t(inputs["x"]), _t(inputs["w"])
    out = {}
    for n in (2, 4):
        mesh = make_nd_mesh({"data": n})
        if not mesh.member:
            continue
        xs = _block(x, 0, mesh, "data").requires_grad_(True)
        ws = _block(w, 0, mesh, "data")
        mean = pmean((xs * xs).sum(), mesh.group("data"))
        mean.backward()
        g_mean = _whole(xs.grad, 0, mesh, "data")
        xs.grad = None
        rows = gather(xs, 0, mesh.group("data"))
        (w * rows).sum().backward()
        g_rows = _whole(xs.grad, 0, mesh, "data")
        xs.grad = None
        shifted = ring_shift_on(xs, mesh, "data")
        (ws * shifted).sum().backward()
        out[n] = {
            "pmean": float(mean), "pmean_grad": g_mean.numpy(),
            "rows": rows.detach().numpy(), "rows_grad": g_rows.numpy(),
            "shift": _whole(shifted, 0, mesh, "data").numpy(),
            "shift_grad": _whole(xs.grad, 0, mesh, "data").numpy(),
        }
    return out


# -------------------------------------------------------- ring attention
RING_MESHES = {"seq2": {"seq": 2}, "seq4": {"seq": 4}, "data2xseq2": {"data": 2, "seq": 2}}


@job
def ring_attention(inputs: dict, workdir: Path) -> dict:
    """The ring's output and the gradients of ``sum(out * g)`` on each
    mesh of ``RING_MESHES``, whole."""
    from mlops_tpu_torch.parallel.ring_attention import make_ring_attention

    q, k, v, g = (_t(inputs[n]) for n in ("q", "k", "v", "g"))
    out = {}
    for name, axes in RING_MESHES.items():
        mesh = make_nd_mesh(axes)
        if not mesh.member:
            continue
        batch = "data" if "data" in axes else None
        ring = make_ring_attention(mesh, "seq")

        def local(t):
            t = _block(t, 1, mesh, "seq")
            return _block(t, 0, mesh, "data") if batch else t

        lq, lk, lv = (local(t).requires_grad_(True) for t in (q, k, v))
        lo = ring(lq, lk, lv)
        (lo * local(g)).sum().backward()

        def whole(t):
            t = _whole(t, 1, mesh, "seq")
            return _whole(t, 0, mesh, "data") if batch else t

        out[name] = {"out": whole(lo).numpy(),
                     **{f"d{n}": whole(t.grad).numpy() for n, t in zip("qkv", (lq, lk, lv))}}
    return out


# ------------------------------------------------------------------ GPipe
PIPE_MESHES = {"stage2": {"stage": 2}, "stage4": {"stage": 4},
               "data2xstage2": {"data": 2, "stage": 2}}


def pipe_stage(w: dict, h: torch.Tensor) -> torch.Tensor:
    """The tests' stage: ``tanh(h @ W + b)`` of one stage's weights."""
    return torch.tanh(h @ w["W"] + w["b"])


@job
def gpipe(inputs: dict, workdir: Path) -> dict:
    """``make_pipeline`` forward and the gradients of ``sum(y * g)`` on
    each mesh of ``PIPE_MESHES``, whole (the stages' and the data blocks'
    gradients gathered; the weights' summed over 'data')."""
    from mlops_tpu_torch.parallel.pipeline import make_pipeline

    W, b, x, g = (_t(inputs[n]) for n in ("W", "b", "x", "g"))
    out = {}
    for name, axes in PIPE_MESHES.items():
        mesh = make_nd_mesh(axes)
        if not mesh.member:
            continue
        batch = "data" if "data" in axes else None
        run = make_pipeline(mesh, pipe_stage)
        stages = axes["stage"]
        w = {"W": _block(W[:stages], 0, mesh, "stage").requires_grad_(True),
             "b": _block(b[:stages], 0, mesh, "stage").requires_grad_(True)}
        lx = _block(x, 1, mesh, "data").requires_grad_(True)
        lg = _block(g, 1, mesh, "data")
        y = run(w, lx)
        (y * lg).sum().backward()
        grads = {}
        for n, t in w.items():
            gr = t.grad
            if batch:
                gr = all_reduce_sum(gr, mesh.group("data"))
            grads[f"d{n}"] = _whole(gr, 0, mesh, "stage").numpy()
        out[name] = {"y": (_whole(y, 1, mesh, "data") if batch else y).detach().numpy(),
                     "dx": (_whole(lx.grad, 1, mesh, "data") if batch else lx.grad).numpy(),
                     **grads}
    return out


# ------------------------------------------------------------ data mesh
@job
def tune_mesh(inputs: dict, workdir: Path) -> dict:
    """``run_hpo`` (random search and SHA) with the trial axis over 'data'
    meshes of 2 and 4 ranks, fed the JAX sweep's init and batches."""
    from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig
    from mlops_tpu_torch.data.encode import EncodedDataset
    from mlops_tpu_torch.train import hpo

    train = EncodedDataset(*inputs["train_ds"])
    valid = EncodedDataset(*inputs["valid_ds"])
    out = {}
    for n in (2, 4):
        mesh = make_mesh(n)
        if not mesh.member:
            continue
        for strategy in ("random", "sha"):
            if (n, strategy) not in inputs["tune_seams"]:
                continue
            seam = inputs["tune_seams"][(n, strategy)]
            table = seam["indices"]

            def index_source(ids, step, table=table):
                return table[np.asarray(ids), step]

            init = [{k: _t(v) for k, v in p.items()} for p in seam["init"]]
            hcfg = {**inputs["tune_hpo"], "strategy": strategy}
            if strategy == "sha":
                hcfg["trials"] = inputs["tune_hpo_sha_trials"]
            res = hpo.run_hpo(
                ModelConfig(**inputs["tune_model"]), TrainConfig(**inputs["tune_train"]),
                HPOConfig(**hcfg), train, valid,
                device="cpu", init=init, index_source=index_source, mesh=mesh,
            )
            out[(n, strategy)] = {
                "best_index": res.best_index, "best_hyperparams": res.best_hyperparams,
                "trials": res.trials, "best_params": _np(res.best_params),
            }
    return out


@job
def score_mesh(inputs: dict, workdir: Path) -> dict:
    """``score_dataset`` with each chunk's rows over 'data' meshes of 2
    and 4 ranks (a ragged tail chunk included)."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.data.encode import EncodedDataset
    from mlops_tpu_torch.parallel.bulk import score_dataset

    bundle = load_bundle(inputs["score_bundle"])
    ds = EncodedDataset(*inputs["score_ds"])
    out = {}
    for n in (2, 4):
        mesh = make_mesh(n)
        if not mesh.member:
            continue
        res = score_dataset(bundle, ds, chunk_rows=inputs["score_chunk"], exact=True,
                            device="cpu", mesh=mesh)
        out[n] = {"predictions": res.predictions, "outliers": res.outliers,
                  "drift": res.feature_drift}
    return out


@job
def batch_scorer(inputs: dict, workdir: Path) -> dict:
    """Probabilities of rows over 'data' meshes of 2 and 4 ranks through
    the bulk path's row split (``sharding.row_block`` and
    ``gather_tensor``): each rank scores its block, the blocks gathered."""
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.parallel.sharding import batch_sharding, gather_tensor, row_block
    from mlops_tpu_torch.weights import load_params

    model = load_params(build_model(ModelConfig(**inputs["tune_model"])),
                        {k: _t(v) for k, v in inputs["scorer_params"].items()}).eval()
    cat, num = _t(inputs["scorer_rows"][0]), _t(inputs["scorer_rows"][1])
    out = {}
    for n in (2, 4):
        mesh = make_mesh(n)
        if mesh.member:
            rows = row_block(cat.shape[0], mesh)
            with torch.inference_mode():
                local = torch.sigmoid(model(cat[rows], num[rows]))
            out[n] = gather_tensor(local, batch_sharding(mesh, 1), mesh).numpy()
    return out


# ------------------------------------------------------------- DP x TP
TP_MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}


def _tp_run(inputs: dict, family: str, mesh, steps: int, **overrides) -> dict:
    from mlops_tpu_torch.train.tensor_parallel import make_tp_trainer

    config = _configs(inputs, family, **overrides)
    init = {k: _t(v) for k, v in inputs["init"][family].items()}
    trainer = make_tp_trainer(config, mesh=mesh, init_state=init, device="cpu")
    cat, num, lab = (_t(a) for a in inputs["batch"])
    step = trainer.step
    loss0 = step.backward(1, cat, num, lab)
    grads = step.gather({n: p.grad for n, p in step.model.named_parameters()})
    step.optimizer.step()
    losses = [float(loss0)] + [float(step.step(s, cat, num, lab)) for s in range(2, steps + 1)]
    return {"losses": losses, "grads": _np(grads), "params": _np(step.gather(step.params()))}


@job
def tp_steps(inputs: dict, workdir: Path) -> dict:
    """Three DP x TP steps of every family on each mesh of ``TP_MESHES``
    from the JAX init: step 1's loss and gradients, the losses, the
    params after them."""
    out = {}
    for name, (dp, tp) in TP_MESHES.items():
        mesh = make_nd_mesh({"data": dp, "model": tp})
        if not mesh.member:
            continue
        for family in inputs["families"]:
            model = {"tensor_parallel": tp}
            out[(family, name)] = _tp_run(inputs, family, mesh, 3, model=model)
    return out


@job
def tp_dropout(inputs: dict, workdir: Path) -> dict:
    """K ranks against one with dropout on: each family at dropout 0.1 on
    (2 x 2) and on one rank, three steps."""
    out = {}
    for name, (dp, tp) in (("1x1", (1, 1)), ("2x2", (2, 2))):
        mesh = make_nd_mesh({"data": dp, "model": tp})
        if not mesh.member:
            continue
        for family in inputs["families"]:
            out[(family, name)] = _tp_run(
                inputs, family, mesh, 3, model={"tensor_parallel": tp, "dropout": 0.1})
    return out


@job
def tp_clip(inputs: dict, workdir: Path) -> dict:
    """The global-norm clip over a 'model' axis of 2: each rank holds a
    block of a split leaf and the whole of a replicated one; the norm of
    the logical gradient crosses 1 only with both blocks counted. Returns
    the clipped gradient, whole, and the clip's norm."""
    from mlops_tpu_torch.config import TrainConfig
    from mlops_tpu_torch.train.loop import ClippedAdamW

    mesh = make_nd_mesh({"model": 2})
    if not mesh.member:
        return {}
    split = _block(_t(inputs["clip_split"]), 0, mesh, "model")
    rep = _t(inputs["clip_rep"])
    params = [torch.nn.Parameter(torch.zeros_like(split)), torch.nn.Parameter(torch.zeros_like(rep))]
    params[0].grad, params[1].grad = split.clone(), rep.clone()
    opt = ClippedAdamW(params, TrainConfig(), sharded=[True, False], group=mesh.group("model"))
    local_norm = float(torch.sqrt(split.square().sum() + rep.square().sum()))
    opt.step()
    return {"split": _whole(params[0].grad, 0, mesh, "model").numpy(),
            "rep": params[1].grad.numpy(), "local_norm_rank0": local_norm}


# --------------------------------------------------------------- GPipe PP
PP_MESHES = {"stage2": {"data": 1, "stage": 2}, "data2xstage2": {"data": 2, "stage": 2}}


@job
def pp_steps(inputs: dict, workdir: Path) -> dict:
    """The PP trainer of bert and ft_transformer on each mesh of
    ``PP_MESHES`` from the JAX stage layout: step 1's loss and (merged)
    gradients, three losses, the merged params."""
    from mlops_tpu_torch.config import ModelConfig, TrainConfig
    from mlops_tpu_torch.train.pipeline_parallel import (
        make_pp_train_step,
        merge_trunk_params,
        pp_tree,
    )

    out = {}
    for name, axes in PP_MESHES.items():
        mesh = make_nd_mesh(axes)
        if not mesh.member:
            continue
        for family in ("bert", "ft_transformer"):
            mcfg = ModelConfig(**inputs["pp_models"][family], pipeline_stages=axes["stage"])
            tcfg = TrainConfig(**inputs["pp_train"])
            dense = merge_trunk_params(pp_tree(
                {k: _t(v) for k, v in inputs["pp_layout"][family].items()}))
            trainer = make_pp_train_step(mcfg, tcfg, mesh, init_state=dense, device="cpu")
            cat, num, lab = (_t(a) for a in inputs["pp_batch"])
            loss0 = trainer.backward(1, cat, num, lab)
            grads = trainer.dense_params({n: p.grad for n, p in trainer.model.named_parameters()})
            trainer.optimizer.step()
            losses = [float(loss0)] + [
                float(trainer.step(s, cat, num, lab)) for s in range(2, 4)]
            out[(family, name)] = {"losses": losses, "grads": _np(grads),
                                   "params": _np(trainer.dense_params())}
    return out


@job
def pp_train(inputs: dict, workdir: Path) -> dict:
    """``run_layout_training`` with ``model.pipeline_stages=2`` on the
    whole world (data 2 x stage 2): the bundle the coordinator wrote."""
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    config = load_config([*inputs["pp_cli"], f"registry.root={workdir / 'registry'}",
                          f"registry.run_root={workdir / 'runs'}"])
    result = run_layout_training(config, run_name="pp")
    return {"bundle": str(result.bundle_dir), "model_uri": result.model_uri,
            "history": result.train_result.history}


# --------------------------------------------------------- DP x SP docs
SP_MESHES = {"seq2": {"data": 1, "seq": 2}, "seq4": {"data": 1, "seq": 4},
             "data2xseq2": {"data": 2, "seq": 2}}


@job
def sp_steps(inputs: dict, workdir: Path) -> dict:
    """The doc trainer with the ring on each mesh of ``SP_MESHES`` from the
    JAX init: three losses and the params after them."""
    from mlops_tpu_torch.config import ModelConfig, TrainConfig
    from mlops_tpu_torch.train.long_context import make_doc_train_step
    from mlops_tpu_torch.weights import load_params

    out = {}
    cat, num, lab = (_t(a) for a in inputs["docs"])
    for name, axes in SP_MESHES.items():
        mesh = make_nd_mesh(axes)
        if not mesh.member:
            continue
        trainer = make_doc_train_step(
            ModelConfig(**inputs["doc_model"], seq_parallel=True),
            TrainConfig(**inputs["doc_train"]), mesh=mesh, device="cpu")
        load_params(trainer.model, {k: _t(v) for k, v in inputs["doc_init"].items()})
        losses = [float(trainer.step(cat, num, lab)) for _ in range(3)]
        logits = trainer.eval_logits(trainer.params(), _t(inputs["vdocs"][0]),
                                     _t(inputs["vdocs"][1]), 4)
        out[name] = {"losses": losses, "params": _np(trainer.params()),
                     "logits": logits.numpy()}
    return out


@job
def sp_train(inputs: dict, workdir: Path) -> dict:
    """``run_layout_training`` of the doc model with ``seq_parallel`` on
    the whole world."""
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.train.pipeline import run_layout_training

    config = load_config([*inputs["sp_cli"], f"registry.root={workdir / 'registry'}",
                          f"registry.run_root={workdir / 'runs'}"])
    result = run_layout_training(config, run_name="sp")
    return {"bundle": str(result.bundle_dir), "model_uri": result.model_uri,
            "history": result.train_result.history}


# -------------------------------------------------------- sharded serving
def _serve_answers(engine, inputs: dict) -> dict:
    """``engine``'s responses to the inputs' solo requests (one per
    bucket) and grouped requests, as dicts and as raw arrays, then its
    monitor snapshot."""
    solo, raw = [], []
    for cat, num in inputs["solo"]:
        handle = engine.dispatch_arrays(cat, num)
        arrays = engine.fetch_arrays_raw(handle)
        raw.append(arrays)
        solo.append(_formatted(arrays))
    group, group_raw = [], []
    for parts in inputs["groups"]:
        arrays = engine.fetch_group_raw(engine.dispatch_group_arrays(parts))
        group_raw.append(arrays)
        sizes, preds, outs, drifts = arrays
        group.append([_formatted((preds[i, :n], outs[i, :n], drifts[i]))
                      for i, n in enumerate(sizes)])
    return {"solo": solo, "group": group, "raw": raw, "group_raw": group_raw,
            "snapshot": engine.monitor_snapshot(),
            "dispatches": engine.dispatch_counts()}


def _formatted(arrays) -> dict:
    from mlops_tpu_torch.serve.wire import format_response

    return format_response(*arrays)


def _follower_state(engines: dict, out_of_step: bool, workdir: Path) -> None:
    """What a follower rank holds once the lead stopped it, for the test to
    hold against the lead: each live engine's number, generations,
    buckets, ready solo shapes and last monitor window."""
    import json

    state = {sid: {"bundle_generation": e.bundle_generation,
                   "grid_generation": e.grid_generation,
                   "buckets": list(e.buckets), "shards": e.model_shards,
                   "warmed_solo": _warmed_solo(e),
                   "window": None if e._window is None else e._window.tolist()}
             for sid, e in engines.items()}
    rank = torch.distributed.get_rank()
    (workdir / f"follower{rank}.json").write_text(
        json.dumps({"engines": state, "out_of_step": out_of_step}))


def _warmed_solo(engine) -> list[int]:
    return sorted(lead[0] for _, lead in engine._gen.warmed if len(lead) == 1)


def _fail_after_warm_pass(rows: int) -> None:
    """Make this process's warm pass of a ``rows`` solo shape fail after
    its collectives ran."""
    from mlops_tpu_torch.serve.engine import InferenceEngine

    warm = InferenceEngine._warm_pass

    def failing(self, gen, tier, lead, scratch):
        warm(self, gen, tier, lead, scratch)
        if tuple(lead) == (rows,):
            raise RuntimeError(f"injected failure readying {lead}")

    InferenceEngine._warm_pass = failing


def _out_of_step(mesh) -> bool:
    """Every rank reports another count of collectives: whether ``agree``
    refused the mesh here."""
    from mlops_tpu_torch.parallel.sharding import MeshOutOfStep

    try:
        mesh.agree(True, torch.distributed.get_rank())
    except MeshOutOfStep:
        return True
    return False


@job
def model_shards(inputs: dict, workdir: Path) -> dict:
    """Sharded serving over the whole world as one ('model',) mesh: rank 0
    serves each bundle through the sharded engine (warmup, the buckets,
    a group), then a swap and a rollback, a regrid, the quant refusal
    and ``auto``'s fallback, and a gbm bundle that ignores the mesh; every
    other rank follows. With ``one_rank``, rank 0 also serves each bundle
    over a one-rank mesh beside the unsharded engine. The lead runs with
    the cyclic collector off: an engine it drops is freed at once, and
    the followers drop their twins."""
    import gc

    from mlops_tpu_torch.parallel.sharding import serve_mesh
    from mlops_tpu_torch.serve.shards import follow

    world = torch.distributed.get_world_size()
    mesh = serve_mesh(world, device="cpu")
    one = serve_mesh(1, device="cpu") if inputs["one_rank"] else None
    if not mesh.lead:
        # Bucket 2 fails here after its warm pass's collectives: the lead
        # hears of it, and no rank counts the shape ready.
        _fail_after_warm_pass(2)
        engines = follow(mesh, "cpu")
        _follower_state(engines, _out_of_step(mesh), workdir)
        return {}
    gc.disable()
    try:
        return _lead_model_shards(inputs, mesh, one)
    finally:
        gc.enable()


def _lead_model_shards(inputs: dict, mesh, one) -> dict:
    import weakref

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.parallel.sharding import MeshOutOfStep, sharded_axes
    from mlops_tpu_torch.serve.engine import InferenceEngine

    buckets = tuple(inputs["buckets"])
    out = {"families": {}, "one_rank": {}}

    def engine_on(path, m, warm=False):
        # Warmed or not, a shape runs the same program; on the CPU an unwarmed
        # one is readied at its first dispatch, announced as warmup's are.
        engine = InferenceEngine(load_bundle(path), buckets=buckets, device="cpu", mesh=m)
        if warm:
            engine.warmup()
        return engine

    refs = []
    for family, path in inputs["bundles"].items():
        engine = engine_on(path, mesh, warm=True)
        refs.append(weakref.ref(engine))
        tier = engine._tiers["exact"]
        full = load_bundle(path).model.state_dict()
        out["families"][family] = {
            "shards": engine.model_shards,
            "split": sorted(k for k, v in tier.specs.items() if sharded_axes(v)),
            "specs": tier.specs,
            "blocks": {k: [list(v.shape), list(full[k].shape)]
                       for k, v in tier.params.items()},
            **_serve_answers(engine, inputs),
        }
        if one is not None:
            plain = engine_on(path, None)
            sharded = engine_on(path, one)
            out["one_rank"][family] = {"plain": _serve_answers(plain, inputs),
                                       "sharded": _serve_answers(sharded, inputs)}
    # A swap and a rollback in step: the live engine serves the mlp, the
    # candidate (built over the same mesh) the bert.
    live = engine_on(inputs["bundles"]["mlp"], mesh, warm=True)
    candidate = engine_on(inputs["bundles"]["bert"], mesh)
    cat, num = inputs["solo"][1]
    turns = {"before": live.fetch_arrays_raw(live.dispatch_arrays(cat, num))}
    turns["swap_generation"] = live.swap_bundle(candidate)
    turns["swapped"] = live.fetch_arrays_raw(live.dispatch_arrays(cat, num))
    turns["rollback_generation"] = live.rollback()
    turns["rolled_back"] = live.fetch_arrays_raw(live.dispatch_arrays(cat, num))
    # A regrid in step: bucket 3 warmed, the grid exchanged, 3 rows served.
    turns["warm"] = live.warm_grid((1, 3, *buckets))
    turns["grid_generation"] = live.regrid((1, 3, *buckets))
    turns["regridded"] = live.fetch_arrays_raw(live.dispatch_arrays(cat[:3], num[:3]))
    turns["dispatches"] = live.dispatch_counts()
    turns["snapshot"] = live.monitor_snapshot()
    # A shape that fails on a follower only: ready on no rank, and the mesh
    # serves on in step.
    try:
        live.warm_grid((1, 2, 3, *buckets))
        turns["failed_ready"] = None
    except RuntimeError as err:
        turns["failed_ready"] = str(err)
    turns["warmed_solo"] = _warmed_solo(live)
    turns["after_failure"] = live.fetch_arrays_raw(live.dispatch_arrays(cat[:3], num[:3]))
    out["turnover"] = turns
    # The quant tier under S > 1, demanded and preferred; a gbm bundle.
    try:
        InferenceEngine(load_bundle(inputs["quant_bundle"]), serve_tier="quant",
                        device="cpu", mesh=mesh)
        out["quant"] = None
    except ValueError as err:
        out["quant"] = str(err)
    auto = InferenceEngine(load_bundle(inputs["quant_bundle"]), serve_tier="auto",
                           device="cpu", mesh=mesh, tier_routing=True)
    out["auto"] = {"tier": auto.serve_tier, "tiers": list(auto.available_tiers)}
    built = mesh.built
    gbm = engine_on(inputs["gbm_bundle"], mesh)
    out["gbm"] = {"shards": gbm.model_shards, "tier": gbm.serve_tier,
                  "built": mesh.built - built, **_serve_answers(gbm, inputs)}
    # The engines the lead dropped are gone without a collection; those it
    # holds at the stop are the ones the followers must hold.
    out["freed"] = [ref() is None for ref in refs[:-1]]
    out["live_sid"] = live._sid
    out["held"] = sorted(e._sid for e in (engine, live, candidate, auto))
    mesh.stop()
    # Ranks that ran different numbers of collectives: refused on every
    # rank, and the lead announces nothing more.
    out["out_of_step"] = _out_of_step(mesh)
    try:
        mesh.announce(("stop", -1))
        out["announce_refused"] = False
    except MeshOutOfStep:
        out["announce_refused"] = True
    return out
