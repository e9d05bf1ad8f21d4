"""The port's registered programs for the trace layer (Layer 2).

Each entry wraps a REAL production factory, so the aten graph the
analyzer inspects is the program production runs:

- ``train-step-dense``: ``train/loop.py::train_step`` (loss, backward,
  the clipped AdamW update), traced at two minibatch sizes.
- ``train-step-tp``: ``parallel/steps.py::make_sharded_train_step`` (the
  DP x TP step); needs a process group of two ranks, skipped loudly
  without one.
- ``serve-predict-packed`` / ``serve-predict-group-packed``:
  ``ops/predict.py`` ``make_packed_predict_base`` /
  ``make_packed_grouped_base``, the exact tier's captured programs, at
  every warmup bucket and at the smallest and largest slot bucket.
- ``serve-predict-quant-packed`` / ``serve-predict-quant-group-packed``:
  ``ops/quant_kernel.py``'s factories, traced on the CPU: the plain route
  of ``quant_fused`` (the JAX package traces its jnp composite the same
  way), since the CUDA route's body is a ctypes launch no tracer sees.
- ``serve-predict-gbm-packed`` / ``serve-predict-gbm-group-packed``:
  ``ops/gbm_tensor.py``'s factories; f64 is their declared contract.
- ``bulk-score-chunk``: ``parallel/bulk.py::make_bulk_fused`` at two
  chunk sizes with the int8 categorical ids the chunk scorer sends.

Every argument is built inside the trace's ``FakeTensorMode`` from the
schema's shapes: no parameter is materialized and no device code runs.

``numeric_audit`` (``analyze --numeric``) runs the exact tier's packed
programs under ``utils/debug.checked`` on tiny CONCRETE batches; it
executes, so it is opt-in, not part of the gate.
"""

from __future__ import annotations

from typing import Any

from mlops_tpu_torch.analysis.traces import EntryPoint, ShardingLink

# The model axis of the tensor-parallel entry and of the sharded engine
# its layout feeds (serve.model_shards).
TP_MODEL_AXIS = 2


def _tiny_model_config():
    from mlops_tpu_torch.config import ModelConfig

    # Smallest real family: the analyzer checks program STRUCTURE, which
    # width does not change, so keep tracing cheap.
    return ModelConfig(family="mlp", hidden_dims=(8,), embed_dim=4)


def _tiny_model(device: str):
    import torch

    from mlops_tpu_torch.models import build_model

    # Built on ``device`` (a module of fake tensors cannot be moved).
    with torch.device(device):
        return build_model(_tiny_model_config())


def _schema_batch(lead: tuple[int, ...], device: str, cat_dtype=None):
    import torch

    from mlops_tpu_torch.schema.features import SCHEMA

    return (
        torch.zeros((*lead, SCHEMA.num_categorical), dtype=cat_dtype or torch.int32,
                    device=device),
        torch.zeros((*lead, SCHEMA.num_numeric), dtype=torch.float32, device=device),
        torch.ones(lead, dtype=torch.bool, device=device),
    )


def _monitor(device: str):
    import torch

    from mlops_tpu_torch.monitor.state import DRIFT_REF_SIZE, MonitorState
    from mlops_tpu_torch.schema.features import SCHEMA

    c, m, r = SCHEMA.num_categorical, SCHEMA.num_numeric, DRIFT_REF_SIZE

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return MonitorState(
        cat_ref_counts=f32(c, max(SCHEMA.cards)), num_ref_sorted=f32(m, r),
        num_ref_cdf=f32(m, r), out_mean=f32(m), out_precision=f32(m, m),
        out_threshold=f32(),
    )


def _packed_args(params, device: str, lead: tuple[int, ...], temp_dtype=None):
    import torch

    from mlops_tpu_torch.monitor.state import init_accumulator

    temp = torch.ones((), dtype=temp_dtype or torch.float32, device=device)
    return (params, _monitor(device), init_accumulator(device), temp,
            *_schema_batch(lead, device))


def _serve_buckets() -> tuple[int, ...]:
    from mlops_tpu_torch.config import ServeConfig

    return tuple(ServeConfig().warmup_batch_sizes)


def _group_leads() -> dict[int, tuple[int, int]]:
    from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKET, GROUP_SLOT_BUCKETS

    small, large = GROUP_SLOT_BUCKETS[0], GROUP_SLOT_BUCKETS[-1]
    return {small: (small, GROUP_ROW_BUCKET), large: (large, GROUP_ROW_BUCKET)}


# --------------------------------------------------------------- factories
def _build_train_step_dense(device: str):
    import torch

    from mlops_tpu_torch.config import TrainConfig
    from mlops_tpu_torch.train import loop

    model = _tiny_model(device)
    config = TrainConfig(batch_size=32, steps=8, eval_every=4)
    optimizer = loop.make_optimizer(model, config)

    def step(cat, num, lab):
        # The dropout masks drawn from the default generator: a traced op
        # takes no torch.Generator argument (fake tensors refuse one on
        # some torch versions); the ops are the seeded stream's.
        seeded = loop.dropout_generator
        loop.dropout_generator = lambda *args: None
        try:
            return loop.train_step(model, optimizer, config, 1, cat, num, lab)
        finally:
            loop.dropout_generator = seeded

    def args(rows: int):
        cat, num, _ = _schema_batch((rows,), device)
        return (cat, num, torch.zeros((rows,), dtype=torch.float32, device=device))

    # One step on fakes first: the optimizer makes its state on the first
    # step, and the traced program is the steady state's. Two minibatch
    # sizes: the step must be one program at any batch.
    step(*args(32))
    return step, {32: args(32), 64: args(64)}


def _build_train_step_tp(device: str):
    import torch

    from mlops_tpu_torch.config import TrainConfig
    from mlops_tpu_torch.parallel.mesh import make_mesh
    from mlops_tpu_torch.parallel.steps import make_sharded_train_step

    model = _tiny_model("cpu")
    config = TrainConfig(batch_size=32, steps=8, eval_every=4)
    mesh = make_mesh(TP_MODEL_AXIS, model_parallel=TP_MODEL_AXIS)
    step = make_sharded_train_step(model, config, mesh, torch.device(device))

    def args(rows: int):
        cat, num, _ = _schema_batch((rows,), device)
        return (cat, num, torch.zeros((rows,), dtype=torch.float32, device=device))

    return (lambda cat, num, lab: step.step(1, cat, num, lab)), {64: args(64), 128: args(128)}


def _tp_layout():
    from mlops_tpu_torch.parallel.steps import layout_specs

    return layout_specs(_tiny_model("cpu"), {"data": 1, "model": TP_MODEL_AXIS})


def _sharded_serve_layout():
    # What serve/engine.py lays a sharded engine's params out by
    # (serve.model_shards = TP_MODEL_AXIS, a ('model',) mesh).
    from mlops_tpu_torch.parallel.steps import layout_specs

    return layout_specs(_tiny_model("cpu"), {"model": TP_MODEL_AXIS})


def _build_serve_predict(device: str):
    from mlops_tpu_torch.ops.predict import make_packed_predict_base, model_params

    model = _tiny_model(device)
    entry = make_packed_predict_base(model)
    params = model_params(model)
    # Every bucket the engine captures: the padded-bucket serving contract
    # is exactly TPU304.
    return entry, {b: _packed_args(params, device, (b,)) for b in _serve_buckets()}


def _build_serve_predict_group(device: str):
    from mlops_tpu_torch.ops.predict import make_packed_grouped_base, model_params

    model = _tiny_model(device)
    entry = make_packed_grouped_base(model)
    params = model_params(model)
    return entry, {s: _packed_args(params, device, lead) for s, lead in _group_leads().items()}


def _quant_params(device: str) -> dict[str, Any]:
    import torch

    from mlops_tpu_torch.ops.quant import QUANT_EMBED_DIM, QUANT_HIDDEN
    from mlops_tpu_torch.schema.features import SCHEMA

    c, k, m = SCHEMA.num_categorical, max(SCHEMA.cards), SCHEMA.num_numeric
    e, h = QUANT_EMBED_DIM, QUANT_HIDDEN

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    f32 = torch.float32
    return {
        "embed": t((c, k, e), torch.bfloat16), "w1_q": t((c * e + m, h), torch.int8),
        "w1_s": t((h,), f32), "b1": t((h,), f32), "w2_q": t((h,), torch.int8),
        "w2_s": t((), f32), "b2": t((), f32),
    }


def _build_serve_quant(device: str):
    from mlops_tpu_torch.ops.quant_kernel import make_quant_packed_base

    qparams = _quant_params(device)
    return make_quant_packed_base(), {
        b: _packed_args(qparams, device, (b,)) for b in _serve_buckets()
    }


def _build_serve_quant_group(device: str):
    from mlops_tpu_torch.ops.quant_kernel import make_quant_grouped_base

    qparams = _quant_params(device)
    return make_quant_grouped_base(), {
        s: _packed_args(qparams, device, lead) for s, lead in _group_leads().items()
    }


def _gbm_variables(device: str, trees: int = 4, nodes: int = 7) -> dict[str, Any]:
    import torch

    from mlops_tpu_torch.ops.gbm_tensor import _CAT_LUT_SIZE, GBM_FIELDS

    shapes = {k: (trees, nodes) for k in GBM_FIELDS}
    shapes["cat_go_left"] = (trees * nodes * _CAT_LUT_SIZE,)
    shapes["baseline"] = ()
    return {k: torch.zeros(shapes[k], dtype=dtype, device=device)
            for k, dtype in GBM_FIELDS.items()}


# Smallest real geometry: the traced structure depends on the static
# depth (the traversal's steps) and the tree count (the add chain), not
# on node width.
_GBM_DEPTH = 2


def _build_serve_gbm(device: str):
    import torch

    from mlops_tpu_torch.ops.gbm_tensor import make_gbm_packed_base

    variables = _gbm_variables(device)
    # f64 temperature: the gbm tier's one dtype deviation from the packed
    # contract (the host hybrid divides by the full Python float).
    return make_gbm_packed_base(_GBM_DEPTH), {
        b: _packed_args(variables, device, (b,), torch.float64) for b in _serve_buckets()
    }


def _build_serve_gbm_group(device: str):
    import torch

    from mlops_tpu_torch.ops.gbm_tensor import make_gbm_grouped_base

    variables = _gbm_variables(device)
    return make_gbm_grouped_base(_GBM_DEPTH), {
        s: _packed_args(variables, device, lead, torch.float64)
        for s, lead in _group_leads().items()
    }


def _build_bulk_score_chunk(device: str):
    import torch

    from mlops_tpu_torch.ops.predict import model_params
    from mlops_tpu_torch.parallel.bulk import make_bulk_fused

    model = _tiny_model(device)
    entry = make_bulk_fused(model)
    params = model_params(model)

    def args(chunk: int):
        # int8 categorical ids: the chunk scorer narrows on the host and
        # the program widens them.
        cat, num, mask = _schema_batch((chunk,), device, torch.int8)
        temp = torch.ones((), dtype=torch.float32, device=device)
        return (params, _monitor(device), temp, cat, num, mask)

    # Two chunk sizes: a sweep runs ONE program at any chunk shape.
    return entry, {4096: args(4096), 16_384: args(16_384)}


def registered_entry_points() -> list[EntryPoint]:
    # The exact tier's two monitor families (monitor/state.py
    # drift_scores): up to SMALL_KS_ROWS = 64 rows the dense masked K-S,
    # above it the masked sort. Each bucket is still one capture; TPU304
    # guards new polymorphism inside a family.
    ks_families = ((1, 8, 64), (256,))
    return [
        EntryPoint(name="train-step-dense", build=_build_train_step_dense),
        EntryPoint(
            name="train-step-tp",
            build=_build_train_step_tp,
            min_ranks=TP_MODEL_AXIS,
            # The TP trainer's layout (parallel/steps.py layout_specs by
            # PARAM_RULES), which the sharded engine must share.
            params_out_spec=_tp_layout,
        ),
        EntryPoint(
            name="serve-predict-packed",
            build=_build_serve_predict,
            params_in_spec=_sharded_serve_layout,
            bucket_families=ks_families,
        ),
        EntryPoint(name="serve-predict-group-packed", build=_build_serve_predict_group),
        EntryPoint(
            name="serve-predict-quant-packed",
            build=_build_serve_quant,
            device="cpu",
            # One family: the quant tier runs the dense masked K-S
            # statistic at every bucket (the kernel's, and its plain
            # version's).
            bucket_families=((1, 8, 64, 256),),
        ),
        EntryPoint(name="serve-predict-quant-group-packed",
                   build=_build_serve_quant_group, device="cpu"),
        EntryPoint(
            name="serve-predict-gbm-packed",
            build=_build_serve_gbm,
            # f64 is this entry's contract (bit parity with sklearn's f64
            # tree compares, ops/gbm_tensor.py).
            x64=True,
            bucket_families=ks_families,
        ),
        EntryPoint(name="serve-predict-gbm-group-packed", build=_build_serve_gbm_group,
                   x64=True),
        EntryPoint(name="bulk-score-chunk", build=_build_bulk_score_chunk),
    ]


# Packaged-params handoffs the layout check guards (TPU305): the dense
# trainer packages dense params the engine lays out at load; the TP
# trainer's layout must be the sharded engine's.
LINKS = [
    ShardingLink("train-step-dense", "serve-predict-packed", transport="shard-at-load"),
    ShardingLink("train-step-tp", "serve-predict-packed"),
]


class NumericAuditError(Exception):
    """A numeric-audit failure tagged with the entry point that tripped;
    ``analysis/cli.py`` turns it into the TPU307 finding."""

    def __init__(self, entry: str, detail: str):
        self.entry = entry
        super().__init__(detail)


def numeric_audit(device: str) -> list[str]:
    """The JAX package's opt-in numeric audit (``analyze --numeric``) on
    the port's exact packed programs: each runs under ``utils/debug.
    checked`` on tiny CONCRETE synthetic batches on ``device``. The solo
    form runs with padding rows (requests pad up to their bucket); the
    grouped form runs full slots (a padding slot's chi-squared drift is
    NaN by construction before the fold selects it away). Returns result
    lines; raises ``NumericAuditError`` naming the entry that tripped."""
    import numpy as np
    import torch

    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.models import init_params
    from mlops_tpu_torch.monitor.state import fit_monitor, init_accumulator
    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
        packed_layout,
    )
    from mlops_tpu_torch.utils.debug import NumericCheckError, checked

    columns, labels = generate_synthetic(512, seed=0)
    prep = Preprocessor.fit(columns)
    ds = prep.encode(columns, labels)
    model = init_params(_tiny_model("cpu"), 0).to(device)
    params = model_params(model)
    monitor = fit_monitor(ds).to(device)
    temp = torch.ones((), dtype=torch.float32, device=device)

    def tensors(rows: int, lead: tuple[int, ...]):
        cat = torch.from_numpy(ds.cat_ids[:rows].astype(np.int32)).to(device)
        num = torch.from_numpy(ds.numeric[:rows].astype(np.float32)).to(device)
        return cat.reshape(*lead, -1), num.reshape(*lead, -1)

    bucket, valid = 8, 5  # padding rows exercise the masked drift path
    cat, num = tensors(bucket, (bucket,))
    mask = torch.arange(bucket, device=device) < valid
    try:
        packed, acc = checked(make_packed_predict_base(model))(
            params, monitor, init_accumulator(device), temp, cat, num, mask)
    except NumericCheckError as err:
        raise NumericAuditError("serve-predict-packed", str(err)) from err
    p, _, _ = packed_layout(bucket)
    preds = packed.cpu().numpy()[p][:valid]

    slots, rows = 2, 1  # full slots: every slot folds real drift
    cat, num = tensors(slots * rows, (slots, rows))
    try:
        _, acc = checked(make_packed_grouped_base(model))(
            params, monitor, acc, temp, cat, num,
            torch.ones((slots, rows), dtype=torch.bool, device=device))
    except NumericCheckError as err:
        raise NumericAuditError("serve-predict-group-packed", str(err)) from err
    leaves = (acc.rows, acc.outliers, acc.batches, acc.drift_sum, acc.drift_last)
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise NumericAuditError(
            "serve-predict-group-packed",
            "monitor accumulator left the numeric audit non-finite",
        )
    return [
        f"numeric audit on {device}: serve-predict-packed {valid}/{bucket} padded rows "
        f"under checked float checks — clean "
        f"(p50 prediction {float(np.median(preds)):.4f})",
        f"numeric audit on {device}: serve-predict-group-packed {slots}x{rows} slots + "
        "accumulator fold — clean (aggregate finite)",
    ]
