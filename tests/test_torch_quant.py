"""The port's quant tier against the JAX package's composite route.

State comes from the JAX package (``quantize_student(init_quant_master)``
and ``fit_monitor`` on ``generate_synthetic`` data) and crosses to the
port through ``mlops_tpu_torch.weights``. The reference is the jnp
composite (``use_kernel=False``): off-TPU the Pallas interpret route is
not a parity reference. Tolerances:

- categorical counts and K-S statistics: exact;
- predictions: 1e-6 absolute (f32 matmuls summed in another order);
- drift (1 - p): 1e-5 absolute; NaN in both for all-padding slots;
- outlier flags: exact except rows within 1e-5 x threshold of it;
- accumulator rows / outliers / batches: exact; drift sums 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.data import Preprocessor, generate_synthetic
from mlops_tpu.monitor.state import fit_monitor
from mlops_tpu.monitor.state import init_accumulator as jax_init_accumulator
from mlops_tpu.ops import quant as jquant
from mlops_tpu.ops.quant_kernel import (
    _fused_core,
    make_quant_grouped_base,
    make_quant_packed_base,
)
from mlops_tpu_torch.monitor.state import init_accumulator
from mlops_tpu_torch.ops import quant as tquant
from mlops_tpu_torch.ops import quant_kernel as tkernel
from mlops_tpu_torch.ops.predict import packed_layout
from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS
from mlops_tpu_torch.weights import monitor_from_numpy, quant_params_from_numpy
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

PRED_ATOL = 1e-6
DRIFT_ATOL = 1e-5
FLAG_BAND = 1e-5
TEMPERATURE = np.float32(1.37)

SOLO = [(1, b) for b in (1, 8, 64, 256)]
GROUPS = [(s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS]


@pytest.fixture(scope="module")
def state():
    columns, _ = generate_synthetic(3000, seed=0)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns))
    qparams = jquant.quantize_student(jquant.init_quant_master(3))
    held, _ = generate_synthetic(4096, seed=1, drift=0.4)
    ds = prep.encode(held)
    port = (
        quant_params_from_numpy(
            {k: np.asarray(v) for k, v in qparams.items()}, "cpu"
        ),
        monitor_from_numpy(monitor.to_arrays(), "cpu"),
        torch.tensor(TEMPERATURE),
    )
    return qparams, monitor, port, ds


def _batch(ds, s, b, seed):
    """[S, B, ...] rows with partial masks; groups end in padding slots."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(ds.n, size=s * b, replace=False)
    cat = ds.cat_ids[idx].reshape(s, b, -1)
    num = ds.numeric[idx].reshape(s, b, -1)
    mask = np.zeros((s, b), bool)
    if s == 1:
        mask[0, : max(1, b - b // 4)] = True
    else:
        for i in range(s - max(1, s // 4)):
            mask[i, : rng.integers(1, b + 1)] = True
    return cat, num, mask


def _near(monitor, num):
    diff = num.astype(np.float64) - np.asarray(monitor.out_mean, np.float64)
    d2 = np.einsum("...i,ij,...j->...", diff, np.asarray(
        monitor.out_precision, np.float64), diff)
    thr = float(monitor.out_threshold)
    return np.abs(d2 - thr) <= FLAG_BAND * abs(thr)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantization_matches_reference():
    master = jquant.init_quant_master(5)
    host = {k: np.asarray(v) for k, v in master.items()}
    j_q = jquant.quantize_student(master)
    t_q = tquant.quantize_student(host)
    for key in j_q:
        want = np.asarray(j_q[key].astype(jnp.float32))
        np.testing.assert_array_equal(t_q[key].float().numpy(), want, err_msg=key)
    assert t_q["embed"].dtype == torch.bfloat16
    w = host["w1"]
    np.testing.assert_array_equal(
        tquant.dequantize_dense(*map(_t, tquant.quantize_dense(w))).numpy(),
        np.asarray(jquant.dequantize_dense(*map(jnp.asarray, jquant.quantize_dense(w)))),
    )


def test_one_hot_out_of_range_ids_give_zero_rows():
    ids = torch.tensor([0, 11, 12, -1, 5])
    oh = tquant.one_hot_2d(ids, 12)
    want = np.asarray(jquant.one_hot_2d(jnp.asarray(ids.numpy()), 12))
    np.testing.assert_array_equal(oh.numpy(), want)
    assert oh[2].sum() == 0 and oh[3].sum() == 0


def test_quant_student_logits_match(state):
    qparams, _, (tq, _, _), ds = state
    want = np.asarray(
        jquant.quant_student_logits(qparams, ds.cat_ids[:64], ds.numeric[:64])
    )
    got = tquant.quant_student_logits(
        tq, _t(ds.cat_ids[:64]), _t(ds.numeric[:64])
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_quant_params_roundtrip_through_arrays(state):
    _, _, (tq, _, _), _ = state
    back = tquant.quant_params_from_arrays(tquant.quant_params_to_arrays(tq))
    for key in tq:
        assert back[key].dtype == tq[key].dtype
        assert torch.equal(back[key], tq[key]), key


@pytest.mark.parametrize("s,b", SOLO + GROUPS)
def test_fused_core_matches_reference_body(state, s, b):
    """Counts and K-S statistics exact, predictions 1e-6, flags exact off
    the threshold band — slot by slot against the JAX ``_fused_core``."""
    qparams, monitor, port, ds = state
    cat, num, mask = _batch(ds, s, b, seed=10 * s + b)
    tq, tm, temp = port
    preds, flags, counts, ks = tkernel.fused_core(
        tq["embed"], tq["w1_q"], tq["w1_s"], tq["b1"], tq["w2_q"],
        tq["w2_s"], tq["b2"], tm.num_ref_sorted, tm.num_ref_cdf,
        tm.out_mean, tm.out_precision, tm.out_threshold, temp,
        _t(cat), _t(num), _t(mask),
    )
    core = jax.jit(_fused_core)
    for i in range(s):
        jp, jf, jc, jk = core(
            qparams["embed"], qparams["w1_q"], qparams["w1_s"][None, :],
            qparams["b1"][None, :], qparams["w2_q"][:, None],
            qparams["w2_s"].reshape(1, 1), qparams["b2"].reshape(1, 1),
            monitor.num_ref_sorted, monitor.num_ref_cdf,
            monitor.out_mean[None, :], monitor.out_precision,
            monitor.out_threshold.reshape(1, 1),
            jnp.asarray(TEMPERATURE).reshape(1, 1),
            cat[i], num[i], mask[i].astype(np.float32)[None, :],
        )
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ks[i].numpy(), np.asarray(jk)[0])
        np.testing.assert_allclose(
            preds[i].numpy(), np.asarray(jp)[0], atol=PRED_ATOL, rtol=0
        )
        off = ~_near(monitor, num[i])
        np.testing.assert_array_equal(
            flags[i].numpy()[off], np.asarray(jf)[0][off]
        )



NON_FINITE = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}


def _plant_non_finite(num, mask, value):
    """One non-finite numeric in a valid row, and one in a padding row
    where the batch has one."""
    num = num.copy()
    num[0, 2, 1] = value
    pad = np.argwhere(~mask)
    if len(pad):
        num[tuple(pad[0])][3] = value
    return num


@pytest.mark.parametrize("value", sorted(NON_FINITE))
@pytest.mark.parametrize("s,b", [(1, 8), (4, 8)])
def test_fused_core_keeps_non_finite_numerics_as_the_jax_body(state, s, b, value):
    """A NaN or an infinity in a numeric reaches the prediction as NaN
    (the hidden ReLU keeps it, as ``jnp.maximum`` does); flags, counts
    and K-S statistics equal the JAX ``_fused_core``'s, NaN for NaN."""
    qparams, monitor, port, ds = state
    cat, num, mask = _batch(ds, s, b, seed=5)
    num = _plant_non_finite(num, mask, NON_FINITE[value])
    tq, tm, temp = port
    preds, flags, counts, ks = tkernel.fused_core(
        tq["embed"], tq["w1_q"], tq["w1_s"], tq["b1"], tq["w2_q"],
        tq["w2_s"], tq["b2"], tm.num_ref_sorted, tm.num_ref_cdf,
        tm.out_mean, tm.out_precision, tm.out_threshold, temp,
        _t(cat), _t(num), _t(mask),
    )
    assert torch.isnan(preds[0, 2])
    core = jax.jit(_fused_core)
    for i in range(s):
        jp, jf, jc, jk = core(
            qparams["embed"], qparams["w1_q"], qparams["w1_s"][None, :],
            qparams["b1"][None, :], qparams["w2_q"][:, None],
            qparams["w2_s"].reshape(1, 1), qparams["b2"].reshape(1, 1),
            monitor.num_ref_sorted, monitor.num_ref_cdf,
            monitor.out_mean[None, :], monitor.out_precision,
            monitor.out_threshold.reshape(1, 1),
            jnp.asarray(TEMPERATURE).reshape(1, 1),
            cat[i], num[i], mask[i].astype(np.float32)[None, :],
        )
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ks[i].numpy(), np.asarray(jk)[0])
        np.testing.assert_array_equal(
            np.isnan(preds[i].numpy()), np.isnan(np.asarray(jp)[0])
        )
        np.testing.assert_allclose(
            preds[i].numpy(), np.asarray(jp)[0], atol=PRED_ATOL, rtol=0
        )
        off = ~_near(monitor, num[i])
        np.testing.assert_array_equal(
            flags[i].numpy()[off], np.asarray(jf)[0][off]
        )

def _assert_acc(t_acc, j_acc):
    for key in ("rows", "outliers", "batches"):
        assert float(getattr(t_acc, key)) == float(getattr(j_acc, key)), key
    for key in ("drift_sum", "drift_last"):
        np.testing.assert_allclose(
            getattr(t_acc, key).numpy(), np.asarray(getattr(j_acc, key)),
            atol=DRIFT_ATOL, rtol=0, err_msg=key,
        )


def _assert_packed(got, want, rows, monitor, num):
    p, o, d = packed_layout(rows)
    np.testing.assert_allclose(got[..., p], want[..., p], atol=PRED_ATOL, rtol=0)
    np.testing.assert_allclose(got[..., d], want[..., d], atol=DRIFT_ATOL, rtol=0)
    off = ~_near(monitor, num)
    np.testing.assert_array_equal(got[..., o][off], want[..., o][off])


@pytest.mark.parametrize("b", [b for _, b in SOLO])
def test_packed_program_matches_composite(state, b):
    qparams, monitor, (tq, tm, temp), ds = state
    cat, num, mask = _batch(ds, 1, b, seed=b)
    want, j_acc = jax.jit(make_quant_packed_base(use_kernel=False))(
        qparams, monitor, jax_init_accumulator(), jnp.float32(TEMPERATURE),
        cat[0], num[0], mask[0],
    )
    got, t_acc = tkernel.make_quant_packed_base()(
        tq, tm, init_accumulator("cpu"), temp, _t(cat[0]), _t(num[0]), _t(mask[0])
    )
    _assert_packed(got.numpy(), np.asarray(want), b, monitor, num[0])
    _assert_acc(t_acc, j_acc)


@pytest.mark.parametrize("s,r", GROUPS)
def test_grouped_program_matches_composite(state, s, r):
    qparams, monitor, (tq, tm, temp), ds = state
    cat, num, mask = _batch(ds, s, r, seed=100 + s * r)
    want, j_acc = jax.jit(make_quant_grouped_base(use_kernel=False))(
        qparams, monitor, jax_init_accumulator(), jnp.float32(TEMPERATURE),
        cat, num, mask,
    )
    got, t_acc = tkernel.make_quant_grouped_base()(
        tq, tm, init_accumulator("cpu"), temp, _t(cat), _t(num), _t(mask)
    )
    want = np.asarray(want)
    got = got.numpy()
    padding = ~mask.any(axis=1)
    assert padding.any()
    # All-padding slots: chi-squared over zero rows is NaN in both.
    _, _, d = packed_layout(r)
    assert np.isnan(want[padding][:, d]).any()
    assert np.isnan(got[padding][:, d]).any()
    _assert_packed(got, want, r, monitor, num)
    _assert_acc(t_acc, j_acc)
    assert np.isfinite(t_acc.drift_sum.numpy()).all()


def test_cpu_tensors_take_the_plain_version_and_the_kernel_needs_cuda(state):
    _, _, (tq, tm, temp), ds = state
    cat, num, mask = _batch(ds, 2, 8, seed=7)
    args = (
        tq["embed"], tq["w1_q"], tq["w1_s"], tq["b1"], tq["w2_q"],
        tq["w2_s"], tq["b2"], tm.num_ref_sorted, tm.num_ref_cdf,
        tm.out_mean, tm.out_precision, tm.out_threshold, temp,
        _t(cat), _t(num), _t(mask),
    )
    before = tkernel.quant_kernel_launches.value
    for got, want in zip(
        tkernel.fused_core(*args), tkernel.fused_core_reference(*args)
    ):
        assert torch.equal(got, want)
    assert tkernel.quant_kernel_launches.value == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.fused_core_cuda(*args)


def test_kernel_row_limit_follows_its_shared_memory_layout(state):
    """csrc/quant_fused.cu takes every rows-per-slot B and reference size
    R. Up to 256 rows a K-S block keeps each slot's keys, sorted column
    and ECDF table (3B + 1 words) and 13 words of counters in shared
    memory, past 256 it sorts one slot through a global workspace (P
    words, P = B rounded up to a power of two, with a shared chunk of
    min(P, 4096)); the feature's two reference planes (2R floats) stay in
    shared memory only while they fit beside the slot's words in an H100
    block's 232,448 bytes less 8,192 for static arrays. The served shapes
    (R = 2048, B <= 256) keep everything in shared memory; no shape is
    refused before the wrapper looks for a card."""
    _, _, (tq, tm, temp), _ = state
    r = tm.num_ref_sorted.shape[1]
    limit = 232_448 - 8_192
    for b in range(1, 257):
        route = tkernel.kernel_route(b, r)
        assert (route.slots, route.planes, route.workspace_words) == (
            "shared", "shared", 0
        )
    for b, rr in [(1, 2048), (33, 2048), (256, 2048), (257, 2048),
                  (17_319, 2048), (65_536, 2048), (256, 32_768),
                  (8, 32_768), (20_000, 32_768), (1, 28_000)]:
        route = tkernel.kernel_route(b, rr)
        pow2 = 1 << (b - 1).bit_length()
        if b <= 256:
            group = max(32, pow2)
            slot_words = (256 // group) * (3 * b + 1 + 13)
            assert (route.slots, route.workspace_words) == ("shared", 0)
        else:
            slot_words = min(pow2, 4096)
            assert (route.slots, route.workspace_words) == ("global", pow2)
        fits = 4 * (2 * rr + slot_words) <= limit
        assert route.planes == ("shared" if fits else "global")
        assert route.smem_bytes == 4 * ((2 * rr if fits else 0) + slot_words)
        assert route.smem_bytes <= limit
    # The old all-shared layout refused 17,319 rows at R = 2048; the planes of a
    # 32,768-point reference (256 KB) never fit.
    assert tkernel.kernel_route(1, 32_768).planes == "global"
    assert tkernel.kernel_route(17_319, 2048).slots == "global"

    def args(b):
        return (
            tq["embed"], tq["w1_q"], tq["w1_s"], tq["b1"], tq["w2_q"],
            tq["w2_s"], tq["b2"], tm.num_ref_sorted, tm.num_ref_cdf,
            tm.out_mean, tm.out_precision, tm.out_threshold, temp,
            torch.zeros((1, b, 9), dtype=torch.int32),
            torch.zeros((1, b, 14), dtype=torch.float32),
            torch.ones((1, b), dtype=torch.bool),
        )

    for b in (1, 32, 33, 256, 257, 17_318, 17_319):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tkernel.fused_core_cuda(*args(b))