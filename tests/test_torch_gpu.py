"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every case skips (the kernels have no
CPU mode). This file imports torch and the port only, so it also runs on
a machine without JAX:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances, quant_fused: categorical counts and K-S statistics exact
(integer counts, correctly rounded f32 divisions), predictions 1e-6
absolute, flags exact except rows within 1e-5 x threshold of it.

Tolerances, flash attention: f32 out 2e-5 and lse 1e-5 (the same f32
arithmetic summed tile by tile); bf16 out 2e-2 (two bf16 ulps at |out|
near 1: p is rounded to bf16 at another running max than the one-pass
plain version's) and lse 1e-3.

Tolerances, flash backward (dq, dk, dv): f32 5e-5 absolute plus 1e-4 of
the gradient's largest magnitude (the JAX package's own tolerance for
ragged flash gradients: the same f32 arithmetic in another summation
order); bf16 two bf16 ulps at the gradient's largest magnitude (the
kernel and the plain version round ds and p to bf16 from f32 values
that differ in the last bits, and each rounds its f32 sum once).
"""

import numpy as np
import pytest
import torch

from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.ops import attention, quant_kernel
from mlops_tpu_torch.ops.outlier import mahalanobis_sq
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS

PRED_ATOL = 1e-6
FLAG_BAND = 1e-5
SHAPES = [(1, b) for b in (1, 8, 64, 256)] + [
    (s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS
]


@pytest.fixture(scope="module")
def card_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    columns, _ = generate_synthetic(5000, seed=0)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns)).to(dev)
    qparams = {
        k: v.to(dev) for k, v in quantize_student(init_quant_master(0)).items()
    }
    held, _ = generate_synthetic(4096, seed=1, drift=0.4)
    return qparams, monitor, prep.encode(held), dev


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", SHAPES)
def test_kernel_matches_plain_version_on_the_card(card_state, s, b):
    qp, mon, ds, dev = card_state
    rng = np.random.default_rng(s * 1000 + b)
    idx = rng.choice(ds.n, size=s * b, replace=False)
    cat = torch.from_numpy(ds.cat_ids[idx].reshape(s, b, -1)).to(dev)
    num = torch.from_numpy(ds.numeric[idx].reshape(s, b, -1)).to(dev)
    mask = torch.zeros((s, b), dtype=torch.bool)
    for i in range(max(1, s - s // 4)):
        mask[i, : int(rng.integers(1, b + 1))] = True
    mask = mask.to(dev)
    args = (
        qp["embed"], qp["w1_q"], qp["w1_s"], qp["b1"], qp["w2_q"],
        qp["w2_s"], qp["b2"], mon.num_ref_sorted, mon.num_ref_cdf,
        mon.out_mean, mon.out_precision, mon.out_threshold,
        torch.tensor(1.3, device=dev), cat, num, mask,
    )
    before = quant_kernel.quant_kernel_launches.value
    kp, kf, kc, kk = quant_kernel.fused_core_cuda(*args)
    torch.cuda.synchronize()
    assert quant_kernel.quant_kernel_launches.value == before + 1
    rp, rf, rc, rk = quant_kernel.fused_core_reference(*args)
    assert torch.equal(kc, rc) and torch.equal(kk, rk)
    assert (kp - rp).abs().max().item() <= PRED_ATOL
    d2 = mahalanobis_sq(num, mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    off = (d2 - thr).abs() > FLAG_BAND * thr.abs()
    assert torch.equal(kf[off], rf[off])


FLASH_SHAPES = [  # (B, S_q, S_kv, H, D)
    (2, 128, 128, 4, 32),
    (1, 200, 200, 2, 16),
    (2, 45, 70, 2, 32),
    (4, 140, 140, 2, 16),
    (2, 200, 200, 4, 64),
    (2, 200, 200, 4, 8),
    (2, 45, 70, 2, 8),
    (1, 140, 140, 2, 128),
    (2, 70, 45, 2, 128),
]
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-3)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s_q, s_kv, h, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
        .to(dev, dtype)
        for s in (s_q, s_kv, s_kv)
    )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s_q,s_kv,h,d", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version_on_the_card(b, s_q, s_kv, h, d, dtype):
    dev = _card()
    q, k, v = _qkv(b, s_q, s_kv, h, d, dtype, dev, seed=s_q * 7 + d)
    before = attention.flash_kernel_launches.value
    out, lse = attention.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_kernel_launches.value == before + 1
    ref_out, ref_lse = attention.flash_forward_reference(q, k, v)
    out_tol, lse_tol = FLASH_TOL[dtype]
    assert out.dtype == dtype and out.shape == (b, s_q, h, d)
    assert lse.shape == (b * h, s_q)
    assert (out.float() - ref_out.float()).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_reads_strided_qkv_views(dtype):
    """The doc model hands the kernel q, k and v as views of one qkv
    projection [B, S, 3, H, D]: no copy, same result."""
    dev = _card()
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.normal(size=(3, 140, 3, 2, 32)).astype(np.float32)
    ).to(dev, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = attention.flash_forward_cuda(q, k, v)
    ref_out, ref_lse = attention.flash_forward_reference(q, k, v)
    out_tol, lse_tol = FLASH_TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


@pytest.mark.gpu
def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    q, k, v = _qkv(2, 24, 24, 2, 24, torch.float32, dev, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_forward_cuda(q, k, v)
    q, k, v = _qkv(2, 24, 24, 2, 16, torch.float16, dev, seed=0)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.flash_forward_cuda(q, k, v)
    # On the card, attend takes the kernel at S >= 128 and the dense
    # reference below it.
    q, k, v = _qkv(1, 130, 130, 2, 16, torch.bfloat16, dev, seed=1)
    before = attention.flash_kernel_launches.value
    attention.attend(q, k, v)
    attention.attend(q[:, :100], k[:, :100], v[:, :100])
    assert attention.flash_kernel_launches.value == before + 1


@pytest.mark.gpu
def test_flash_launch_into_preallocated_outputs_equals_the_wrapper():
    """``launch`` (what chip_smoke.py times) is the wrapper's own launch:
    into reused outputs it gives the wrapper's result bit for bit and
    counts once per call."""
    dev = _card()
    q, k, v = _qkv(2, 200, 200, 4, 32, torch.bfloat16, dev, seed=5)
    want_out, want_lse = attention.flash_forward_cuda(q, k, v)
    out, lse = torch.full_like(want_out, float("nan")), torch.full_like(want_lse, float("nan"))
    before = attention.flash_kernel_launches.value
    attention.launch(q, k, v, out, lse)
    attention.launch(q, k, v, out, lse)
    torch.cuda.synchronize()
    assert attention.flash_kernel_launches.value == before + 2
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


BWD_SHAPES = [  # (B, S_q, S_kv, H, D): ragged edges, cross-length, each head_dim
    (2, 128, 128, 4, 32),
    (1, 200, 200, 2, 16),
    (2, 45, 70, 2, 32),
    (4, 140, 140, 2, 16),
    (2, 200, 200, 4, 64),
    (2, 70, 45, 2, 64),
    (2, 200, 200, 4, 8),
    (2, 45, 70, 2, 8),
    (1, 140, 140, 2, 128),
    (2, 70, 45, 2, 128),
]


def _grad_tol(want: torch.Tensor) -> float:
    big = want.float().abs().max().item()
    if want.dtype == torch.bfloat16:
        return 2 * 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7)
    return 5e-5 + 1e-4 * big


def _bwd_inputs(b, s_q, s_kv, h, d, dtype, dev, seed):
    q, k, v = _qkv(b, s_q, s_kv, h, d, dtype, dev, seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.normal(size=(b, s_q, h, d)).astype(np.float32))
    out, lse = attention.flash_forward_cuda(q, k, v)
    return q, k, v, out, lse, do.to(dev, dtype)


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _grad_tol(w), (name, err, _grad_tol(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s_q,s_kv,h,d", BWD_SHAPES)
def test_flash_backward_kernels_match_plain_version_on_the_card(b, s_q, s_kv, h, d, dtype):
    dev = _card()
    q, k, v, out, lse, do = _bwd_inputs(b, s_q, s_kv, h, d, dtype, dev, seed=s_kv + d)
    before = (attention.flash_bwd_dq_launches.value, attention.flash_bwd_dkv_launches.value)
    got = attention.flash_backward_cuda(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    after = (attention.flash_bwd_dq_launches.value, attention.flash_bwd_dkv_launches.value)
    assert after == (before[0] + 1, before[1] + 1)
    _assert_grads_close(got, attention.flash_backward_reference(q, k, v, out, lse, do))


@pytest.mark.gpu
def test_flash_backward_kernels_at_the_training_shape():
    """The doc model's training shape, q, k and v as views of one qkv
    projection [64, 508, 3, 8, 32] bf16."""
    dev = _card()
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(
        rng.normal(size=(64, 508, 3, 8, 32)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.from_numpy(
        rng.normal(size=(64, 508, 8, 32)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    out, lse = attention.flash_forward_cuda(q, k, v)
    got = attention.flash_backward_cuda(q, k, v, out, lse, do)
    _assert_grads_close(got, attention.flash_backward_reference(q, k, v, out, lse, do))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_function_gradients_on_the_card_match_the_plain_route(dtype):
    """Autograd through ``flash_attention`` on the card (forward kernel,
    both backward kernels) against the same Function on CPU copies (the
    plain versions)."""
    dev = _card()
    rng = np.random.default_rng(21)
    host = [
        torch.from_numpy(rng.normal(size=(2, s, 4, 32)).astype(np.float32)).to(dtype)
        for s in (150, 150, 150, 150)
    ]
    grads = {}
    for where in ("cuda", "cpu"):
        q, k, v = (x.to(where).requires_grad_() for x in host[:3])
        out = attention.attend(q, k, v, use_flash=True)
        assert isinstance(out.grad_fn, attention.FlashAttention._backward_cls)
        out.backward(host[3].to(where))
        grads[where] = (q.grad.cpu(), k.grad.cpu(), v.grad.cpu())
    _assert_grads_close(grads["cuda"], grads["cpu"])


@pytest.mark.gpu
def test_flash_backward_launch_into_preallocated_outputs_equals_the_wrapper():
    dev = _card()
    q, k, v, out, lse, do = _bwd_inputs(2, 200, 200, 4, 32, torch.bfloat16, dev, seed=9)
    delta = attention.flash_delta(out, do)
    want_dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    want_dk, want_dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (want_dq, want_dk, want_dv))
    before = (attention.flash_bwd_dq_launches.value, attention.flash_bwd_dkv_launches.value)
    attention.launch_dq(q, k, v, do, lse, delta, dq)
    attention.launch_dkv(q, k, v, do, lse, delta, dk, dv)
    torch.cuda.synchronize()
    after = (attention.flash_bwd_dq_launches.value, attention.flash_bwd_dkv_launches.value)
    assert after == (before[0] + 1, before[1] + 1)
    assert torch.equal(dq, want_dq) and torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


# The bf16 forward works on 128-row query blocks over 128-key tiles and
# dk/dv on 128-key blocks over 64-query tiles: lengths on each side of
# those edges, the doc model's 508, cross lengths both ways, every
# head_dim, q, k and v as views of one qkv projection.
EDGE_LENGTHS = [127, 128, 129, 255, 256, 257, 508]
EDGE_CASES = [(s, s) for s in EDGE_LENGTHS] + [(45, 70), (70, 45)]


def _edge_inputs(s_q, s_kv, d, dev, seed):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dev, torch.bfloat16
        )

    if s_q == s_kv:
        qkv = normal(2, s_q, 3, 2, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = normal(2, s_q, 2, d), normal(2, s_kv, 2, d), normal(2, s_kv, 2, d)
    return q, k, v, normal(2, s_q, 2, d)


@pytest.mark.gpu
@pytest.mark.parametrize("d", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("s_q,s_kv", EDGE_CASES)
def test_bf16_forward_at_the_tile_edges(s_q, s_kv, d):
    dev = _card()
    q, k, v, _ = _edge_inputs(s_q, s_kv, d, dev, seed=s_q * 31 + s_kv + d)
    out, lse = attention.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention.flash_forward_reference(q, k, v)
    out_tol, lse_tol = FLASH_TOL[torch.bfloat16]
    assert torch.isfinite(lse).all()
    assert (out.float() - ref_out.float()).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


@pytest.mark.gpu
@pytest.mark.parametrize("d", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("s_q,s_kv", EDGE_CASES)
def test_bf16_dkv_at_the_tile_edges(s_q, s_kv, d):
    dev = _card()
    q, k, v, do = _edge_inputs(s_q, s_kv, d, dev, seed=s_q * 37 + s_kv + d)
    out, lse = attention.flash_forward_cuda(q, k, v)
    delta = attention.flash_delta(out, do)
    dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    _, want_dk, want_dv = attention.flash_backward_reference(q, k, v, out, lse, do)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _grad_tol(want), (err, _grad_tol(want))


@pytest.mark.gpu
def test_dkv_launches_are_bitwise_equal():
    """Each dk/dv block owns its key rows and sums its query tiles in one
    order (no atomics): two launches give the same bits."""
    dev = _card()
    q, k, v, do = _edge_inputs(508, 508, 32, dev, seed=17)
    out, lse = attention.flash_forward_cuda(q, k, v)
    delta = attention.flash_delta(out, do)
    first = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    second = attention.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("d", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("s_q,s_kv", EDGE_CASES)
def test_bf16_dq_at_the_tile_edges(s_q, s_kv, d):
    """dq's 128-row query blocks over 64-key tiles: lengths on each side of
    both edges, the doc model's 508, cross lengths both ways."""
    dev = _card()
    q, k, v, do = _edge_inputs(s_q, s_kv, d, dev, seed=s_q * 41 + s_kv + d)
    out, lse = attention.flash_forward_cuda(q, k, v)
    dq = attention.flash_bwd_dq_cuda(q, k, v, do, lse, attention.flash_delta(out, do))
    torch.cuda.synchronize()
    want = attention.flash_backward_reference(q, k, v, out, lse, do)[0]
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= _grad_tol(want), (err, _grad_tol(want))


@pytest.mark.gpu
def test_dq_launches_are_bitwise_equal():
    """Each dq block owns its query rows and sums its key tiles in one
    order (no atomics): two launches give the same bits."""
    dev = _card()
    q, k, v, do = _edge_inputs(508, 508, 32, dev, seed=19)
    out, lse = attention.flash_forward_cuda(q, k, v)
    delta = attention.flash_delta(out, do)
    first = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    second = attention.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _ks_edge_batch(ds, ref_sorted, s, b, seed):
    """Numerics that break a sorted-batch merge: exact reference points,
    ties within the slot, values below the reference minimum and above its
    maximum. With S > 1, slot 0 holds one valid row, slot 1 none and the
    others 0..B rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ds.n, size=s * b)
    cat = ds.cat_ids[idx].reshape(s, b, -1)
    num = ds.numeric[idx].reshape(s, b, -1).astype(np.float32)
    ref = ref_sorted.cpu().numpy()
    m, r = ref.shape
    span = ref[:, -1] - ref[:, 0] + 1.0
    pick = rng.integers(0, 5, size=(s, b, m))
    num = np.where(pick == 1, ref[np.arange(m), rng.integers(0, r, size=(s, b, m))], num)
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
    return cat, num, mask


def _quant_args(card_state, cat, num, mask):
    qp, mon, _, dev = card_state
    return (
        qp["embed"], qp["w1_q"], qp["w1_s"], qp["b1"], qp["w2_q"],
        qp["w2_s"], qp["b2"], mon.num_ref_sorted, mon.num_ref_cdf,
        mon.out_mean, mon.out_precision, mon.out_threshold,
        torch.tensor(1.3, device=dev),
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (cat, num, mask)),
    )


@pytest.mark.gpu
@pytest.mark.parametrize(
    "s,b", [(1, 1), (1, 8), (1, 64), (1, 256), (64, 1), (64, 8), (64, 64), (3, 300)]
)
def test_kernel_ks_is_exact_on_inputs_that_break_a_merge(card_state, s, b):
    _, mon, ds, _ = card_state
    cat, num, mask = _ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=s * 7 + b)
    args = _quant_args(card_state, cat, num, mask)
    kp, kf, kc, kk = quant_kernel.fused_core_cuda(*args)
    torch.cuda.synchronize()
    rp, rf, rc, rk = quant_kernel.fused_core_reference(*args)
    assert torch.equal(kc, rc) and torch.equal(kk, rk)
    assert (kp - rp).abs().max().item() <= PRED_ATOL
    numt = args[14]
    d2 = mahalanobis_sq(numt, mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    off = (d2 - thr).abs() > FLAG_BAND * thr.abs()
    assert torch.equal(kf[off], rf[off])


@pytest.mark.gpu
@pytest.mark.parametrize("value", [float("nan"), float("inf"), float("-inf")],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("s,b", [(1, 8), (1, 256), (64, 8)])
def test_kernel_keeps_non_finite_numerics_as_its_plain_version(card_state, s, b, value):
    """A NaN or an infinity in one valid row's numeric: that row's
    prediction is NaN from the kernel as from the plain version (whose
    ReLU keeps a NaN, as the reference's maximum does); every other
    output as in the finite case, with NaN where the plain version has
    NaN."""
    _, mon, ds, _ = card_state
    cat, num, mask = _ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=11)
    mask[0, 0] = True
    num = num.copy()
    num[0, 0, 1] = value
    args = _quant_args(card_state, cat, num, mask)
    kp, kf, kc, kk = quant_kernel.fused_core_cuda(*args)
    torch.cuda.synchronize()
    rp, rf, rc, rk = quant_kernel.fused_core_reference(*args)
    assert torch.isnan(kp[0, 0]) and torch.isnan(rp[0, 0])
    assert torch.equal(kp.isnan(), rp.isnan())
    assert torch.equal(kc, rc) and torch.equal(kk.isnan(), rk.isnan())
    assert torch.equal(kk.nan_to_num(), rk.nan_to_num())
    assert (kp - rp).nan_to_num().abs().max().item() <= PRED_ATOL
    d2 = mahalanobis_sq(args[14], mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    off = ((d2 - thr).abs() > FLAG_BAND * thr.abs()) | d2.isnan()
    assert torch.equal(kf[off], rf[off])

@pytest.mark.gpu
@pytest.mark.parametrize("s,b", [(64, 1), (64, 8)])
def test_grouped_launches_are_bitwise_equal(card_state, s, b):
    """Every output element has one owner (a warp per row, a slot group
    per slot and feature): two launches give the same bits."""
    _, mon, ds, _ = card_state
    args = _quant_args(card_state, *_ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=3))
    first = quant_kernel.fused_core_cuda(*args)
    second = quant_kernel.fused_core_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.fixture(scope="module")
def large_ref_state(card_state):
    """A monitor fitted with drift_ref_size 32,768 (the JAX config bounds
    it by nothing): its planes do not fit a block's shared memory."""
    qparams, _, ds, dev = card_state
    columns, _ = generate_synthetic(40_000, seed=2)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=32_768).to(dev)
    return qparams, monitor, ds, dev


# (R, S, B): the planes from global memory, a slot past 256 rows sorted
# through the workspace (just past the old shared-memory limit of 17,318
# rows at R = 2048, and at a size that is not a power of two), both.
LARGE_SHAPES = [
    (32_768, 1, 256), (32_768, 64, 8), (2048, 1, 17_408), (2048, 3, 300),
    (32_768, 1, 5000),
]


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,b", LARGE_SHAPES)
def test_kernel_ks_is_exact_past_the_shared_memory_layout(
    card_state, large_ref_state, r, s, b
):
    state = large_ref_state if r == 32_768 else card_state
    _, mon, ds, _ = state
    assert mon.num_ref_sorted.shape[1] == r
    route = quant_kernel.kernel_route(b, r)
    assert (route.slots, route.planes) != ("shared", "shared")
    cat, num, mask = _ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=r + s + b)
    args = _quant_args(state, cat, num, mask)
    kp, kf, kc, kk = quant_kernel.fused_core_cuda(*args)
    torch.cuda.synchronize()
    rp, rf, rc, rk = quant_kernel.fused_core_reference(*args)
    assert torch.equal(kc, rc) and torch.equal(kk, rk)
    assert (kp - rp).abs().max().item() <= PRED_ATOL
    d2 = mahalanobis_sq(args[14], mon.out_mean, mon.out_precision)
    thr = mon.out_threshold
    off = (d2 - thr).abs() > FLAG_BAND * thr.abs()
    assert torch.equal(kf[off], rf[off])


# The exact tier's models at the served widths (bf16) and a seeded init:
# the packed programs on the card against the port's CPU route. bf16
# predictions within 1.6e-2 (four bf16 ulps of a logit below 4 times the
# sigmoid's slope; cuBLAS and the CPU round bf16 products in other
# places), flags exact off the threshold band, accumulator rows and
# batches exact, drift within 1e-5 (p-values of the same statistics
# computed on two devices).
EXACT_MODELS = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(256, 256, 128), embed_dim=16),
    "mlp-ens8": dict(family="mlp", hidden_dims=(256, 256, 128), embed_dim=16,
                     ensemble_size=8),
}


def _exact_model(name):
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model

    model = build_model(ModelConfig(precision="bf16", **EXACT_MODELS[name]))
    rng = np.random.default_rng(len(name))
    with torch.no_grad():
        for key, p in model.named_parameters():
            scale = 1 / np.sqrt(p.shape[-2]) if key.endswith("kernel") else 0.5
            p.copy_(torch.from_numpy((scale * rng.normal(size=tuple(p.shape))).astype(np.float32)))
    return model.eval()


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", [(1, 1), (1, 256), (64, 1), (64, 8)])
@pytest.mark.parametrize("name", sorted(EXACT_MODELS))
def test_exact_tier_on_the_card_matches_the_cpu_route(card_state, name, s, b):
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
        packed_layout,
    )

    _, mon, ds, dev = card_state
    cat, num, mask = _ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=s + b)
    outs = {}
    for device in ("cpu", dev):
        model = _exact_model(name).to(device)
        program = (make_packed_predict_base if s == 1 else make_packed_grouped_base)(model)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (cat, num, mask)]
        if s == 1:
            inputs = [t[0] for t in inputs]
        with torch.inference_mode():
            packed, acc = program(
                model_params(model), mon.to(device), init_accumulator(device),
                torch.tensor(1.2, device=device), *inputs,
            )
        outs[str(device)] = (packed.cpu(), acc)
    (got, got_acc), (want, want_acc) = outs["cuda"], outs["cpu"]
    p, o, d = packed_layout(b)
    assert (got[..., p] - want[..., p]).abs().max().item() <= 1.6e-2
    numt = torch.from_numpy(num.reshape(-1, num.shape[-1]))
    mon_cpu = mon.to("cpu")
    d2 = mahalanobis_sq(numt, mon_cpu.out_mean, mon_cpu.out_precision)
    off = ((d2 - mon_cpu.out_threshold).abs() > FLAG_BAND * mon_cpu.out_threshold.abs())
    off = off.reshape(got[..., o].shape)
    assert torch.equal(got[..., o][off], want[..., o][off])
    assert torch.equal(got[..., d].isnan(), want[..., d].isnan())
    assert (got[..., d] - want[..., d]).nan_to_num(0.0).abs().max().item() <= 1e-5
    assert float(got_acc.rows) == float(want_acc.rows)
    assert float(got_acc.batches) == float(want_acc.batches)


# Tolerances, the dense trainer on the card: one step's gradients against
# the CPU's on the same params and batch, per leaf a cosine of at least
# 0.98 and a norm ratio within 5 % (bf16 products summed in another
# order; the tolerance of chip_smoke.py's phase 18), the loss within 1e-2
# relative; f32 within 1e-4 of each leaf's largest magnitude (TF32 is off,
# so only the summation order differs).
TRAIN_FAMILIES = {
    "linear": dict(family="linear"),
    "mlp": dict(family="mlp", hidden_dims=(64, 64, 32), embed_dim=8),
    "mlp-ens4": dict(family="mlp", hidden_dims=(32, 16), embed_dim=4, ensemble_size=4),
    "ft_transformer": dict(family="ft_transformer", token_dim=32, depth=2, heads=4),
    "bert": dict(family="bert", token_dim=32, depth=2, heads=4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TRAIN_FAMILIES))
def test_one_step_gradients_on_the_card_match_the_cpu(name, precision):
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.schema.features import SCHEMA
    from mlops_tpu_torch.train.loop import training_loss

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(TRAIN_FAMILIES[name], precision=precision, dropout=0.0)
    rng = np.random.default_rng(3)
    cat = np.stack([rng.integers(0, c, 256) for c in SCHEMA.cards], axis=-1).astype(np.int32)
    num = rng.normal(size=(256, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(256) < 0.3).astype(np.float32)
    grads, losses = {}, {}
    for device in ("cpu", "cuda"):
        model = init_params(build_model(ModelConfig(**kw)), 0).to(device)
        loss = training_loss(model, *(torch.from_numpy(a).to(device) for a in (cat, num, lab)),
                             None, 3.0)
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-2 * abs(losses["cpu"])
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        if precision == "f32":
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), k
            continue
        g, w = got.flatten(), want.flatten()
        cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
        assert cos >= 0.98, (k, cos)
        assert abs(g.norm().item() / w.norm().item() - 1) <= 0.05, k


# The serving engine's CUDA graphs (serve/graphs.py) against the same
# programs run eagerly on the card: bitwise equal, packed outputs and
# accumulator alike, for every tier, bucket and group geometry. Engines
# serve a bundle of the served mlp-ens8 widths with a gated quant tier,
# with tier routing on, so one engine holds both tiers.
@pytest.fixture(scope="module")
def serving_engines(card_state, tmp_path_factory):
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, mon, ds, _ = card_state
    columns, _ = generate_synthetic(5000, seed=0)
    prep = Preprocessor.fit(columns)
    path = tmp_path_factory.mktemp("graph_bundle")
    save_exact_bundle(
        path, ModelConfig(precision="bf16", **EXACT_MODELS["mlp-ens8"]),
        _exact_model("mlp-ens8"), prep, mon.to("cpu"),
        calibration={"temperature": 1.2},
        quant_params=quantize_student(init_quant_master(0)),
        quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}},
    )
    bundle = load_bundle(path)
    graphs = InferenceEngine(bundle, tier_routing=True)
    eager = InferenceEngine(bundle, tier_routing=True, cuda_graphs=False)
    graphs.warmup()
    eager.warmup()
    return graphs, eager, ds


def _bits(arr):
    return np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)


def _acc_bits(engine):
    with engine._acc_lock, torch.cuda.stream(engine._stream):
        flat = engine._acc_flat.cpu()
    return flat.numpy().view(np.uint32)


def _parts(ds, slots, rows, seed):
    rng = np.random.default_rng(seed)
    sizes = [rows] * slots if rows == 1 else list(rng.integers(1, rows + 1, slots))
    idx = rng.integers(0, ds.n, size=sum(sizes))
    bounds = np.cumsum([0, *sizes])
    return [(ds.cat_ids[idx[lo:hi]], ds.numeric[idx[lo:hi]])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def _dispatch(engine, ds, key, seed, tier):
    """One dispatch of ``key`` (``(rows,)`` solo or ``(slots, rows)``) on
    the same seeded inputs; returns the packed host buffer."""
    if len(key) == 1:
        rows = key[0]
        n = max(1, rows - seed % 3)
        idx = np.random.default_rng(seed).integers(0, ds.n, size=n)
        handle = engine.dispatch_arrays(ds.cat_ids[idx], ds.numeric[idx], tier=tier)
    else:
        slots, rows = key
        handle = engine.dispatch_group_arrays(
            _parts(ds, slots, rows, seed), tier=tier
        )
    return handle.wait().copy()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["exact", "quant"])
def test_graph_replay_is_bitwise_equal_to_the_eager_program(serving_engines, tier):
    graphs, eager, ds = serving_engines
    assert graphs.warmup_stats["route"] == "cuda_graphs"
    assert graphs.warmup_stats["programs"] == 32 == len(graphs._graphs)
    assert graphs.warmup_stats["graph_pool_bytes"] > 0
    graphs.monitor_snapshot()
    eager.monitor_snapshot()
    keys = [(b,) for b in graphs.buckets] + [
        (s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS
    ]
    for k, key in enumerate(keys):
        got = _dispatch(graphs, ds, key, 10 * k + 1, tier)
        want = _dispatch(eager, ds, key, 10 * k + 1, tier)
        assert np.array_equal(_bits(got), _bits(want)), (tier, key)
        assert np.array_equal(_acc_bits(graphs), _acc_bits(eager)), (tier, key)


@pytest.mark.gpu
def test_overlapped_dispatches_from_threads_match_serial_dispatches(serving_engines):
    """8 threads x 50 dispatches of mixed shapes and tiers give each
    request the bits a serial dispatch gives it."""
    from concurrent.futures import ThreadPoolExecutor

    graphs, _, ds = serving_engines
    keys = [(1,), (8,), (64,), (256,), (2, 1), (64, 1), (16, 8), (64, 8)]
    jobs = [(keys[i % len(keys)], 1000 + i, ("exact", "quant")[i % 2])
            for i in range(400)]
    serial = [_dispatch(graphs, ds, *job) for job in jobs]
    with ThreadPoolExecutor(8) as pool:
        overlapped = list(pool.map(lambda job: _dispatch(graphs, ds, *job), jobs))
    for job, got, want in zip(jobs, overlapped, serial):
        assert np.array_equal(_bits(got), _bits(want)), job


@pytest.mark.gpu
def test_monitor_counts_are_exact_after_replays(serving_engines):
    graphs, eager, ds = serving_engines
    base = {e: e.monitor_snapshot() for e in (graphs, eager)}
    rows = batches = 0
    for k, key in enumerate([(1,), (8,), (256,), (4, 1), (64, 8)] * 3):
        for engine in (graphs, eager):
            _dispatch(engine, ds, key, 77 + k, ("exact", "quant")[k % 2])
        if len(key) == 1:
            rows += max(1, key[0] - (77 + k) % 3)
            batches += 1
        else:
            rows += sum(len(c) for c, _ in _parts(ds, *key, 77 + k))
            batches += key[0]
    snaps = {e: e.monitor_snapshot() for e in (graphs, eager)}
    delta = {e: {f: snaps[e][f] - base[e][f] for f in ("rows", "outliers", "batches")}
             for e in (graphs, eager)}
    assert delta[graphs] == delta[eager]
    assert (delta[graphs]["rows"], delta[graphs]["batches"]) == (rows, batches)


@pytest.mark.gpu
def test_a_scrape_during_warmup_neither_breaks_capture_nor_counts(serving_engines):
    import threading

    from mlops_tpu_torch.serve.engine import InferenceEngine

    graphs, eager, ds = serving_engines
    engine = InferenceEngine(graphs.bundle, tier_routing=True)
    stop = threading.Event()
    scrapes = []

    def scrape():
        while not stop.is_set():
            scrapes.append(engine.monitor_snapshot()["rows"])

    thread = threading.Thread(target=scrape)
    thread.start()
    try:
        engine.warmup()
    finally:
        stop.set()
        thread.join()
    assert scrapes and set(scrapes) == {0.0}
    assert engine.monitor_snapshot()["rows"] == 0.0
    for k, key in enumerate([(1,), (64, 8)]):
        got = _dispatch(engine, ds, key, 500 + k, "exact")
        want = _dispatch(eager, ds, key, 500 + k, "exact")
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_a_capture_under_traffic_keeps_every_answer(serving_engines):
    """A shape warmup did not cover is captured on first use while other
    threads dispatch warmed ones: every answer keeps the eager bits."""
    from concurrent.futures import ThreadPoolExecutor

    graphs, eager, ds = serving_engines
    jobs = [(((1,), (8,), (64, 1), (16, 8))[i % 4], 3000 + i, "exact")
            for i in range(200)]
    want = [_dispatch(eager, ds, *job) for job in jobs]
    novel = [((300 + 17 * k,), 4000 + k, ("exact", "quant")[k % 2]) for k in range(4)]
    want_novel = [_dispatch(eager, ds, *job) for job in novel]
    with ThreadPoolExecutor(4) as pool:
        traffic = pool.map(lambda job: _dispatch(graphs, ds, *job), jobs)
        captured = [_dispatch(graphs, ds, *job) for job in novel]
        traffic = list(traffic)
    for got, exp in zip(traffic + captured, want + want_novel):
        assert np.array_equal(_bits(got), _bits(exp))
    assert all((tier, (rows - seed % 3,)) in graphs._graphs
               for (rows,), seed, tier in novel)


@pytest.mark.gpu
def test_the_launch_counter_counts_graph_replays(serving_engines):
    graphs, _, ds = serving_engines
    counter = quant_kernel.quant_kernel_launches
    replays = graphs.dispatch_counts()
    before = counter.value
    for k, key in enumerate([(1,), (256,), (64, 1), (8, 8)] * 2):
        _dispatch(graphs, ds, key, 900 + k, "quant")
        _dispatch(graphs, ds, key, 900 + k, "exact")
    assert counter.value - before == 8
    after = graphs.dispatch_counts()
    quant = sum(n - replays.get(e, 0) for e, n in after.items() if e.endswith("@quant"))
    assert quant == 8


@pytest.mark.gpu
def test_a_failed_capture_fails_warmup(serving_engines, monkeypatch):
    from mlops_tpu_torch.serve import graphs as graph_module
    from mlops_tpu_torch.serve.engine import InferenceEngine

    def broken(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graph_module, "capture", broken)
    engine = InferenceEngine(serving_engines[0].bundle)
    with pytest.raises(RuntimeError, match="capturing"):
        engine.warmup()
    assert not engine.ready


@pytest.mark.gpu
def test_a_hot_swap_keeps_the_aggregate_exact_and_rolls_back_bitwise(
    serving_engines, tmp_path
):
    """The lifecycle's promotion on the card: the candidate's programs
    are captured again over the live engine's accumulator, so after
    ``swap_bundle`` every row served folds into the live aggregate once,
    rows scored on the candidate's own engine never do, the answers are
    the candidate's eager program's bits, a cheap-tier request serves on
    the candidate's default tier, and ``rollback`` gives back the
    incumbent's bits, quant tier included."""
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.serve.engine import InferenceEngine

    graphs, eager, ds = serving_engines
    model = _exact_model("mlp-ens8")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    incumbent = graphs.bundle
    save_exact_bundle(tmp_path, ModelConfig(precision="bf16", **EXACT_MODELS["mlp-ens8"]),
                      model, incumbent.preprocessor, incumbent.monitor,
                      calibration={"temperature": 1.3})
    candidate_bundle = load_bundle(tmp_path)
    live = InferenceEngine(incumbent, tier_routing=True)
    candidate = InferenceEngine(candidate_bundle, tier_routing=True)
    candidate_eager = InferenceEngine(candidate_bundle, cuda_graphs=False)
    for engine in (live, candidate, candidate_eager):
        engine.warmup()
    keys = [((1,), "exact"), ((256,), "quant"), ((64, 8), "exact"), ((4, 1), "quant")]
    before = [_dispatch(live, ds, key, 5 + k, tier) for k, (key, tier) in enumerate(keys)]
    base = live.monitor_snapshot()["rows"]
    _dispatch(live, ds, (8,), 3, None)  # 8 rows left in the window across the swap
    assert live.swap_bundle(candidate) == 2
    assert live.swap_stats["graphs"] == 16 and live.available_tiers == ("exact",)
    assert live.route_tier(1) is None
    for k, (key, tier) in enumerate(keys):
        got = _dispatch(live, ds, key, 5 + k, tier)
        want = _dispatch(candidate_eager, ds, key, 5 + k, None)
        assert np.array_equal(_bits(got), _bits(want)), key
    _dispatch(candidate, ds, (64,), 9, None)  # folds into the candidate's own
    rows = 8 + sum(
        max(1, key[0] - (5 + k) % 3) if len(key) == 1
        else sum(len(c) for c, _ in _parts(ds, *key, 5 + k))
        for k, (key, _) in enumerate(keys)
    )
    assert live.monitor_snapshot()["rows"] - base == rows
    assert live.rollback() == 3 and live.available_tiers == ("quant", "exact")
    for k, (key, tier) in enumerate(keys):
        got = _dispatch(live, ds, key, 5 + k, tier)
        assert np.array_equal(_bits(got), _bits(before[k])), key


@pytest.mark.gpu
def test_live_engines_never_share_a_stream(serving_engines):
    """torch's stream pool wraps after 32 draws; engines built one after
    another (a lifecycle loop's shadow engines beside the serving one)
    must still never hold another live engine's stream, and a capture
    stream is nobody's serving stream."""
    from mlops_tpu_torch.device import own_stream
    from mlops_tpu_torch.serve.engine import InferenceEngine

    graphs, _, _ = serving_engines
    fresh = []
    for k in range(24):  # 48 more pool draws: past the pool's wrap
        fresh = fresh[-4:] + [InferenceEngine(graphs.bundle)]
        alive = [graphs, *fresh]
        with own_stream(graphs.device) as retrain:
            held = [e._stream.cuda_stream for e in alive]
            held += [e._capture_stream.cuda_stream for e in alive]
            held.append(retrain.cuda_stream)
            assert len(set(held)) == len(held), k


@pytest.mark.gpu
@pytest.mark.parametrize("key", [(1,), (64, 8)])
def test_a_dispatch_fault_fires_on_the_host_at_every_replay(serving_engines, key):
    """The engine's dispatch fault points fire on the host before the
    graph replay: once per dispatch, never only at capture; a delay rule
    leaves the answers bitwise, and a raise replays nothing and leaves the
    engine serving."""
    from mlops_tpu_torch import faults

    graphs, _, ds = serving_engines
    point = "serve.engine.dispatch" if len(key) == 1 else "serve.engine.dispatch_group"
    want = [_dispatch(graphs, ds, key, 40 + k, None) for k in range(5)]
    plan = faults.arm(faults.FaultPlan.from_rules([{"point": point, "mode": "delay"}]))
    try:
        got = [_dispatch(graphs, ds, key, 40 + k, None) for k in range(5)]
    finally:
        faults.disarm()
    assert [hit for _, hit, _, _ in plan.trace()] == list(range(5))
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))
    counts = graphs.dispatch_counts()
    faults.arm(faults.FaultPlan.from_rules([{"point": point, "mode": "raise"}]))
    try:
        with pytest.raises(faults.FaultInjected):
            _dispatch(graphs, ds, key, 40, None)
    finally:
        faults.disarm()
    assert graphs.dispatch_counts() == counts
    assert np.array_equal(_bits(_dispatch(graphs, ds, key, 40, None)), _bits(want[0]))


@pytest.mark.gpu
def test_a_corrupt_kernel_cache_read_is_discarded_and_rebuilt(tmp_path):
    """Bit flips in the bytes read for a cached library's sha256 check:
    the library is discarded (counted), nvcc builds it again, and the
    healed cache is reused."""
    import ctypes

    from mlops_tpu_torch import faults
    from mlops_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        pytest.skip("needs the card machine's nvcc")
    source = cuda_build.PACKAGE_DIR / "csrc" / "quant_fused.cu"
    cuda_build.set_cache_dir(tmp_path)
    try:
        first = cuda_build.build_shared_library(source, "quant_fused")
        discards, calls = cuda_build.cache_discards(), cuda_build.nvcc_calls()
        faults.arm(faults.FaultPlan.from_rules(
            [{"point": "compilecache.read", "mode": "corrupt", "flip_bits": 8}]))
        try:
            again = cuda_build.build_shared_library(source, "quant_fused")
        finally:
            faults.disarm()
        assert not again.reused and again.path == first.path
        assert cuda_build.cache_discards() == discards + 1
        assert cuda_build.nvcc_calls() == calls + 1
        assert cuda_build.build_shared_library(source, "quant_fused").reused
        assert ctypes.CDLL(str(again.path)).quant_fused_launch is not None
    finally:
        cuda_build.set_cache_dir(None)


# ------------------------------------------------------------ bulk scoring
# Bulk sweeps on the card (parallel/bulk.py): the staged executor's
# threads, the pinned staging ring, the compute stream and the fetch
# waves. Predictions of the card against its own depth-1 sweep: bitwise;
# against the CPU route: the exact tier's 1.6e-2 (bf16 model), 1e-6 for
# the quant student's f32 forward, flags exact off the threshold band.
BULK_PATHS = {"exact": dict(exact=True), "distilled": dict(exact=False),
              "quant": dict(tier="quant")}


@pytest.fixture(scope="module")
def bulk_bundle(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep's streams and pinned ring are the card's")
    import dataclasses

    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.data.encode import EncodedDataset
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train.distill import DistillResult

    columns, _ = generate_synthetic(5000, seed=0)
    prep = Preprocessor.fit(columns)
    config = ModelConfig(hidden_dims=(64, 64, 32), ensemble_size=8)
    student = dataclasses.replace(config, ensemble_size=1, hidden_dims=(64, 64), dropout=0.0)
    directory = tmp_path_factory.mktemp("bulk") / "bundle"
    save_exact_bundle(
        directory, config, init_params(build_model(config), 0), prep,
        fit_monitor(prep.encode(columns)), calibration={"temperature": 1.2},
        quant_params=quantize_student(init_quant_master(0)),
        quant={"fidelity": {}, "temperature": 0.9, "gates": {"passed": True}},
        bulk=DistillResult(student, init_params(build_model(student), 1).state_dict(), {}),
    )
    held, _ = generate_synthetic(41 * 1024 + 7, seed=2, drift=0.3)
    ds = prep.encode(held)
    return directory, EncodedDataset(ds.cat_ids, ds.numeric), load_bundle


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BULK_PATHS))
def test_bulk_depth_one_and_two_are_bitwise_equal_on_the_card(bulk_bundle, name):
    from mlops_tpu_torch.parallel import bulk

    directory, ds, load = bulk_bundle
    b = load(directory)
    small = ds.slice(np.arange(3 * 4096 + 5))
    runs = [bulk.score_dataset(b, small, chunk_rows=4096, pipeline_depth=d,
                               device="cuda", **BULK_PATHS[name]) for d in (1, 2, 3)]
    assert runs[0].path == name
    for other in runs[1:]:
        assert np.array_equal(runs[0].predictions.view(np.uint32),
                              other.predictions.view(np.uint32))
        assert np.array_equal(runs[0].outliers, other.outliers)
        assert runs[0].feature_drift == other.feature_drift
    cpu = bulk.score_dataset(load(directory), small, chunk_rows=4096, device="cpu",
                             **BULK_PATHS[name])
    tol = 1e-6 if name == "quant" else 1.6e-2
    assert np.abs(runs[1].predictions - cpu.predictions).max() <= tol
    b_cpu = load(directory)
    num = torch.from_numpy(small.numeric)
    d2 = mahalanobis_sq(num, b_cpu.monitor.out_mean, b_cpu.monitor.out_precision).numpy()
    off = np.abs(d2 - float(b_cpu.monitor.out_threshold)) > FLAG_BAND * float(
        b_cpu.monitor.out_threshold)
    assert np.array_equal(runs[1].outliers[off], cpu.outliers[off])


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 3])
def test_a_sweep_past_the_pinned_ring_and_the_fetch_wave(bulk_bundle, depth):
    """41 chunks: the staging ring (depth + 1 buffers) wraps many times and
    the compute stage may run a full fetch wave (32 chunks) ahead."""
    from mlops_tpu_torch.parallel import bulk

    directory, ds, load = bulk_bundle
    b = load(directory)
    got = bulk.score_dataset(b, ds, chunk_rows=1024, pipeline_depth=depth,
                             device="cuda", exact=True)
    want = bulk.score_dataset(b, ds, chunk_rows=1024, pipeline_depth=1,
                              device="cuda", exact=True)
    assert got.pipeline["items"] == 42 and got.rows == ds.n
    assert np.array_equal(got.predictions.view(np.uint32), want.predictions.view(np.uint32))
    assert np.array_equal(got.outliers, want.outliers)
    scorer = bulk.make_chunk_scorer(b, exact=True, device="cuda")
    last = slice(41 * 1024, ds.n)
    probs, _ = scorer.score(
        torch.from_numpy(ds.cat_ids[last]).cuda(), torch.from_numpy(ds.numeric[last]).cuda(),
        torch.ones(ds.n - 41 * 1024, dtype=torch.bool, device="cuda"))
    assert np.abs(probs.cpu().numpy() - got.predictions[last]).max() <= 1.6e-2


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_an_error_in_the_compute_stage_ends_the_sweep(bulk_bundle, monkeypatch, depth):
    import threading

    from mlops_tpu_torch.parallel import bulk

    directory, ds, load = bulk_bundle
    calls = {"n": 0}
    real = bulk.ChunkScorer.__call__

    def failing(self, chunk):
        calls["n"] += 1
        if calls["n"] == 4:  # the warm-up chunk, then the third of the sweep
            raise RuntimeError("compute failed on the card")
        return real(self, chunk)

    monkeypatch.setattr(bulk.ChunkScorer, "__call__", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="compute failed on the card"):
        bulk.score_dataset(load(directory), ds, chunk_rows=1024, pipeline_depth=depth,
                           device="cuda", exact=True)
    assert threading.active_count() == before


# ------------------------------------------------- the stacked HPO trainer
HPO_MLP = dict(family="mlp", hidden_dims=(64, 64), embed_dim=8, dropout=0.1)


def _hpo_stack(trials: int, device: str, precision: str = "f32", seed: int = 0, **model):
    from mlops_tpu_torch.config import HPOConfig, ModelConfig, TrainConfig
    from mlops_tpu_torch.data.encode import EncodedDataset
    from mlops_tpu_torch.train import hpo

    columns, labels = generate_synthetic(4000, seed=3)
    ds = Preprocessor.fit(columns).encode(columns, labels)
    train = EncodedDataset(ds.cat_ids[:3200], ds.numeric[:3200], ds.labels[:3200])
    valid = EncodedDataset(ds.cat_ids[3200:], ds.numeric[3200:], ds.labels[3200:])
    hp = hpo.sample_hyperparams(HPOConfig(trials=trials, seed=seed))
    seeds = hpo.trial_seeds(seed, trials)
    return hpo.TrialStack(
        ModelConfig(precision=precision, **{**HPO_MLP, **model}),
        TrainConfig(batch_size=256, ema_decay=0.9), hp, seeds, 40,
        hpo.SweepData.put(train, valid, device), torch.device(device),
    )


@pytest.mark.gpu
def test_the_stacked_step_equals_per_trial_steps_on_the_card():
    """f32, dropout on: 3 trials stacked against each trained alone, 5
    steps; losses 1e-5, params 1e-5 (cuBLAS batches the products in
    another order than single ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack = _hpo_stack(3, "cuda")
    losses = stack.run(5)
    for i in range(3):
        alone = _hpo_stack(3, "cuda")
        alone.keep(np.asarray([i]))
        torch.testing.assert_close(alone.run(5)[:, 0], losses[:, i], rtol=0, atol=1e-5)
        torch.testing.assert_close(alone.eval_params()[0], stack.eval_params()[i],
                                   rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_the_stacked_trainer_on_the_card_matches_its_cpu_route(precision):
    """3 trials from the same init and rows: per-trial gradient cosine at
    the first step >= 0.98, then 20 steps' loss curves within 0.05."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stacks = {d: _hpo_stack(3, d, precision) for d in ("cuda", "cpu")}
    grads = {d: s.loss_and_grad()[1].float().cpu() for d, s in stacks.items()}
    cos = torch.nn.functional.cosine_similarity(grads["cuda"], grads["cpu"], dim=1)
    assert float(cos.min()) >= 0.98, cos
    curves = {d: s.run(20).float().cpu() for d, s in stacks.items()}
    assert float((curves["cuda"] - curves["cpu"]).abs().max()) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mlp", "ft_transformer"])
def test_kernels_per_stacked_step_do_not_grow_with_the_trials(family):
    """Device kernels of one step at T = 2 and T = 10 (torch.profiler):
    the same program, batched, so within 10 %."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = {} if family == "mlp" else dict(family=family, token_dim=32, depth=2, heads=4)
    counts = {}
    for t in (2, 10):
        stack = _hpo_stack(t, "cuda", "bf16", **model)
        stack.run(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stack.run(3)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        counts[t] = sum(e.count for e in kernels) / 3
    assert counts[10] <= 1.1 * counts[2], counts


@pytest.mark.gpu
def test_the_sha_survivor_gather_stays_on_the_card():
    """Survivors gathered on the device continue as if trained straight
    through alone: the buffers stay on the card, the trial ids follow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack = _hpo_stack(4, "cuda", seed=2)
    stack.run(6)
    stack.keep(np.asarray([3, 1, 0])[::-1][:2])  # argsort(...)[::-1] gives a reversed view
    assert stack.trial_ids.tolist() == [0, 1]
    for buf in (stack.flat, stack.mu, stack.nu, stack.ema, stack.lr, stack.keys):
        assert buf.is_cuda and buf.shape[0] == 2
    stack.run(6)
    alone = _hpo_stack(4, "cuda", seed=2)
    alone.keep(np.asarray([1]))
    alone.run(12)
    torch.testing.assert_close(alone.eval_params()[0], stack.eval_params()[1], rtol=0, atol=1e-5)


# ------------------------------------------------- the deployed Job on a bucket
@pytest.mark.gpu
def test_the_deployed_job_on_a_bucket_tunes_and_serves_on_the_card():
    """chip_smoke.py's phase 28 at a small size: the manifest's ``tune``
    argv against a fake ``gs://`` bucket on the card, ``promote``, ``serve``
    of the production stage (exact-tier tolerance against the CPU route),
    the environment refusals, TensorBoard and Parquet."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the entry points run on it")
    import chip_smoke

    chip_smoke.WORK.mkdir(parents=True, exist_ok=True)
    out = chip_smoke.phase_deployed_job(extra=(
        "data.rows=3000", "model.hidden_dims=32,32", "model.embed_dim=4", "hpo.trials=3",
        "hpo.steps=30", "train.batch_size=128"))
    assert out["requests_answered"] == 4
    assert out["max_pred_gap_to_cpu"] <= chip_smoke.EXACT_PRED_ATOL + 1e-6
    assert out["ring_max_pred_gap_to_cpu"] <= chip_smoke.EXACT_PRED_ATOL + 1e-6
    assert set(out["refusals"]) == {"MLOPS_TPU_SERVE_LOOP_LAG_MONITOR"}


# ------------------------------------------------------------ the ring plane
@pytest.mark.gpu
def test_a_two_worker_plane_on_the_card_answers_like_the_cpu_route(tmp_path):
    """``serve serve.workers=2`` on the card at a small size (an mlp with a
    gated quant student, tier routing, the kernel cache in ``cache.dir``):
    exact- and quant-tier answers against the port's CPU route (exact 1.6e-2
    + 1e-6, quant 1e-6, drift 1e-5, flags exact off the 1e-5 band), one
    ``quant_fused`` launch per quant-tier dispatch, and a drain exiting 0."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine process serves on it")
    import chip_smoke
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model
    from mlops_tpu_torch.serve.engine import InferenceEngine

    columns, _ = generate_synthetic(3000, seed=0)
    prep = Preprocessor.fit(columns)
    config = ModelConfig(hidden_dims=(32, 32), embed_dim=4, precision="bf16")
    model = build_model(config)
    chip_smoke._seeded_exact_params(model, 0)
    bundle_dir = tmp_path / "bundle"
    save_exact_bundle(bundle_dir, config, model, prep,
                      fit_monitor(prep.encode(columns), drift_ref_size=256),
                      calibration={"temperature": 1.2},
                      quant_params=quantize_student(init_quant_master(0)),
                      quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}})
    port = chip_smoke._free_port()
    root = Path(__file__).resolve().parent.parent
    log = open(tmp_path / "plane.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlops_tpu_torch", "serve", "serve.workers=2",
         "serve.tier_routing=true", f"serve.model_directory={bundle_dir}",
         f"serve.port={port}", "serve.host=127.0.0.1", "serve.warmup_batch_sizes=1,8,64"],
        cwd=root, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(root), MLOPS_TPU_CACHE_DIR=str(tmp_path / "cache")))
    try:
        deadline = time.monotonic() + 300
        while True:
            assert proc.poll() is None, (tmp_path / "plane.log").read_text()[-3000:]
            try:
                if chip_smoke._http(port, "GET", "/healthz/ready")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.2)
        bundle = load_bundle(bundle_dir)
        cpu = InferenceEngine(bundle, buckets=(1, 8, 64), device="cpu", tier_routing=True)
        mon = bundle.monitor
        launches = chip_smoke._metric(chip_smoke._http(port, "GET", "/metrics")[1].decode(),
                                      "mlops_tpu_kernel_launches_total")  # warmup's
        for n in (1, 5, 8, 64):
            columns, _ = generate_synthetic(n, seed=n, drift=0.3)
            recs = [{k: columns[k][i] for k in columns} for i in range(n)]
            for cheap in (False, True):
                request = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict", data=json.dumps(recs).encode(),
                    headers={"x-slo-class": "cheap"} if cheap else {})
                got = json.loads(urllib.request.urlopen(request, timeout=60).read())
                want = cpu.predict_records(recs, tier="quant" if cheap else None)
                np.testing.assert_allclose(got["predictions"], want["predictions"], rtol=0,
                                           atol=PRED_ATOL if cheap else 1.6e-2 + 1e-6)
                np.testing.assert_allclose(list(got["feature_drift_batch"].values()),
                                           list(want["feature_drift_batch"].values()),
                                           rtol=0, atol=1e-5 + 1e-6)
                num = torch.from_numpy(prep.encode(columns).numeric)
                d2 = mahalanobis_sq(num, mon.out_mean, mon.out_precision)
                off = ((d2 - mon.out_threshold).abs() > FLAG_BAND * mon.out_threshold.abs())
                assert (np.asarray(got["outliers"]) == np.asarray(want["outliers"]))[
                    off.numpy()].all()
        text = chip_smoke._http(port, "GET", "/metrics")[1].decode()
        quant = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                    if line.startswith("mlops_tpu_dispatches_total{") and "@quant" in line)
        assert quant == 4
        assert chip_smoke._metric(text, "mlops_tpu_kernel_launches_total") - launches == quant
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()



# ------------------------------------------------- the tenant fleet, replicas
@pytest.fixture(scope="module")
def fleet_dirs(card_state, tmp_path_factory):
    """Three tenants' bundles: mlp-ens8 with a gated quant student, its
    twin from another seed (another student too), and an mlp without one."""
    import chip_smoke
    from mlops_tpu_torch.bundle import save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model

    _, mon, _, _ = card_state
    columns, _ = generate_synthetic(5000, seed=0)
    prep = Preprocessor.fit(columns)
    root = tmp_path_factory.mktemp("fleet")
    dirs = []
    for k, (name, quant) in enumerate((("mlp-ens8", 0), ("mlp-ens8", 3), ("mlp", None))):
        config = ModelConfig(precision="bf16", **EXACT_MODELS[name])
        model = build_model(config)
        chip_smoke._seeded_exact_params(model, 10 + k)
        path = root / f"tenant{k}"
        save_exact_bundle(
            path, config, model, prep, mon.to("cpu"), calibration={"temperature": 1.2},
            **({} if quant is None else dict(
                quant_params=quantize_student(init_quant_master(quant)),
                quant={"fidelity": {}, "temperature": 1.1, "gates": {"passed": True}})))
        dirs.append(path)
    return dirs


def _fleet(dirs):
    from mlops_tpu_torch.tenancy import TenancyConfig, TenantRegistry, TenantSpec

    tenancy = TenancyConfig(tuple(TenantSpec(f"t{k}", str(d)) for k, d in enumerate(dirs)))
    registry = TenantRegistry(tenancy, buckets=(1, 8, 64), device="cuda", tier_routing=True)
    report = registry.warmup()
    return registry, report


@pytest.mark.gpu
def test_no_two_live_engines_of_a_tenant_fleet_share_a_stream(serving_engines, fleet_dirs):
    """A three-tenant fleet beside the serving engine and a retrain's own
    stream: every dispatch and capture stream is held by one engine only;
    the warmup report says no graphs are shared."""
    from mlops_tpu_torch.device import own_stream

    graphs, _, _ = serving_engines
    registry, report = _fleet(fleet_dirs)
    assert report["shared_exec_count"] == 0
    assert report["t1"]["arch_twin_of"] == "t0" and "arch_twin_of" not in report["t2"]
    alive = [graphs, *registry.engines]
    with own_stream(graphs.device) as retrain:
        held = [e._stream.cuda_stream for e in alive]
        held += [e._capture_stream.cuda_stream for e in alive]
        held.append(retrain.cuda_stream)
    assert len(set(held)) == len(held)


@pytest.mark.gpu
def test_each_tenants_graphs_answer_as_its_bundle_alone(card_state, fleet_dirs):
    """Each tenant engine of a fleet replays its own graphs: bitwise the
    answers of an engine serving that bundle alone, on both tiers."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, _, ds, _ = card_state
    registry, _ = _fleet(fleet_dirs)
    for path, engine in zip(fleet_dirs, registry.engines):
        alone = InferenceEngine(load_bundle(path), buckets=(1, 8, 64), tier_routing=True)
        alone.warmup()
        for tier in engine.available_tiers:
            t = None if tier == engine.default_tier else tier
            for key in ((1,), (8,), (64,), (64, 1), (64, 8)):
                for seed in (5, 6):
                    got = _dispatch(engine, ds, key, seed, t)
                    want = _dispatch(alone, ds, key, seed, t)
                    assert np.array_equal(_bits(got), _bits(want)), (path.name, tier, key)
        del alone


@pytest.mark.gpu
def test_each_replica_counts_its_own_launches_and_the_ring_sums_them(fleet_dirs, tmp_path):
    """``serve --workers 2 --replicas 2`` on the card with an empty kernel
    cache: replica 0 builds the kernel, replica 1 loads it (0 nvcc); both
    replicas serve quant-tier requests, and the ring's
    ``mlops_tpu_kernel_launches_total`` is the sum of the replica
    processes' own launches: one per quant-tier dispatch, summed."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import threading
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine processes serve on it")
    import chip_smoke

    port = chip_smoke._free_port()
    root = chip_smoke.ROOT
    log_path = tmp_path / "plane.log"
    log = open(log_path, "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlops_tpu_torch", "serve", "--workers", "2", "--replicas", "2",
         "serve.tier_routing=true", f"serve.model_directory={fleet_dirs[0]}",
         f"serve.port={port}", "serve.host=127.0.0.1", "serve.warmup_batch_sizes=1,8,64"],
        cwd=root, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(root), MLOPS_TPU_CACHE_DIR=str(tmp_path / "cache")))
    try:
        series = chip_smoke._wait_replicas(port, proc, 2, "two replicas", timeout=300)
        _, ready, _ = chip_smoke._ring_log(log_path)
        nvcc = {r["replica"]: r["nvcc_calls"] for r in ready}
        assert nvcc == {0: 1, 1: 0}
        before = chip_smoke._scrape(port)
        rows0 = [chip_smoke._replica(series, "rows_scored_total", r) for r in (0, 1)]
        columns, _ = generate_synthetic(256, seed=4, drift=0.3)
        recs = [{k: columns[k][i] for k in columns} for i in range(256)]
        bodies = [json.dumps(recs[i:i + 1]).encode() for i in range(256)]

        def stream(k):
            for body in bodies[k::16]:
                conn = chip_smoke.http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                conn.request("POST", "/predict", body=body,
                             headers={"x-slo-class": "cheap"})
                assert conn.getresponse().status == 200
                conn.close()

        threads = [threading.Thread(target=stream, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        deadline = time.monotonic() + 30
        while chip_smoke._scrape(port)["rows"] - before["rows"] < 256:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        after = chip_smoke._scrape(port)
        series = chip_smoke._series(port)
        rows = [chip_smoke._replica(series, "rows_scored_total", r) - rows0[r] for r in (0, 1)]
        assert sum(rows) == 256 and min(rows) > 0, rows
        quant = after["quant_dispatches"] - before["quant_dispatches"]
        assert quant > 0
        assert after["launches"] - before["launches"] == quant
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


# ------------------------------------------------- the observability layer
@pytest.mark.gpu
def test_a_traced_ring_request_sums_its_stages_on_the_card(fleet_dirs, tmp_path):
    """``serve --workers 2`` on the card with tracing armed: every span
    carries the JAX ring's stages, the engine half stitched from the slot,
    and its stages sum to its wall clock (1e-3 ms a stage: the 4-place
    rounding)."""
    import json
    import os
    import signal
    import subprocess
    import sys

    import chip_smoke
    from mlops_tpu_torch.trace import load_spans
    from mlops_tpu_torch.trace.span import STAGES

    port = chip_smoke._free_port()
    log = open(tmp_path / "plane.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlops_tpu_torch", "serve", "--workers", "2",
         "serve.tier_routing=true", f"serve.model_directory={fleet_dirs[0]}",
         f"serve.port={port}", "serve.host=127.0.0.1", "serve.warmup_batch_sizes=1,8,64",
         "trace.enabled=true", f"trace.dir={tmp_path / 'traces'}"],
        cwd=chip_smoke.ROOT, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(chip_smoke.ROOT),
                 MLOPS_TPU_CACHE_DIR=str(tmp_path / "cache")))
    try:
        chip_smoke._wait_ready(port, proc, "traced plane", timeout=300)
        columns, _ = generate_synthetic(24, seed=9)
        recs = [{k: columns[k][i] for k in columns} for i in range(24)]
        for i in range(12):
            body = json.dumps(recs[i:i + 1 + i % 3]).encode()
            assert chip_smoke._http(port, "POST", "/predict", body)[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    spans = load_spans(tmp_path / "traces")
    assert len(spans) == 12
    for span in spans:
        assert tuple(span["stages"]) == tuple(s for s in STAGES if s != "queue")
        assert abs(sum(span["stages"].values()) - span["wall_ms"]) <= 7e-3
        assert span["entry"] in ("bucket_1", "bucket_8")


@pytest.mark.gpu
def test_the_degraded_fallback_on_the_card_is_the_warmed_answer(card_state, fleet_dirs):
    """A quant bucket and a group geometry whose graphs are gone, their
    captures failing at ``serve.engine.compile``: the dispatches replay the
    next larger graphs, bitwise the warmed shapes' answers on the same
    rows, and ``degraded_dispatch_total`` counts each."""
    from mlops_tpu_torch import faults
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, _, ds, _ = card_state
    engine = InferenceEngine(load_bundle(fleet_dirs[0]), buckets=(1, 8, 64),
                             serve_tier="quant")
    engine.warmup()
    solo = (ds.cat_ids[:3], ds.numeric[:3])
    parts = [(ds.cat_ids[i:i + 1], ds.numeric[i:i + 1]) for i in range(3, 5)]
    want = (engine.fetch_arrays_raw(engine.dispatch_arrays(*solo)),
            engine.fetch_group_raw(engine.dispatch_group_arrays(parts)))
    engine._gen.graphs.pop(("quant", (8,)))
    engine._gen.graphs.pop(("quant", (2, 1)))
    faults.arm(faults.FaultPlan.from_rules([{"point": "serve.engine.compile", "mode": "raise"}]))
    try:
        solo_handle = engine.dispatch_arrays(*solo)
        group_handle = engine.dispatch_group_arrays(parts)
        got = (engine.fetch_arrays_raw(solo_handle), engine.fetch_group_raw(group_handle))
    finally:
        faults.disarm()
    assert (solo_handle.rows, group_handle.slots, group_handle.rows) == (64, 4, 1)
    assert engine.degraded_dispatch_total == 2
    for a, b in zip(want[0], got[0]):
        assert np.array_equal(_bits(a), _bits(b))
    sizes, preds, outs, drifts = got[1]
    w_sizes, w_preds, w_outs, w_drifts = want[1]
    assert sizes == w_sizes
    for i, n in enumerate(sizes):
        for w, g in ((w_preds[i, :n], preds[i, :n]), (w_outs[i, :n], outs[i, :n]),
                     (w_drifts[i], drifts[i])):
            assert np.array_equal(_bits(w), _bits(g))


@pytest.mark.gpu
def test_the_profile_trace_names_quant_fused_or_its_graph(fleet_dirs, tmp_path):
    """``TorchProfiler`` around quant-tier graph replays writes a trace
    that names the kernel (its events inside the replays) or, where
    CUPTI reports only the launch, the graph launch."""
    import json

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.server import TorchProfiler

    engine = InferenceEngine(load_bundle(fleet_dirs[0]), buckets=(1, 8), serve_tier="quant")
    engine.warmup()
    columns, _ = generate_synthetic(4, seed=3)
    recs = [{k: columns[k][i] for k in columns} for i in range(4)]
    profiler = TorchProfiler(str(tmp_path / "prof"))
    assert profiler.control("start") == (200, None)
    for _ in range(5):
        engine.predict_records(recs)
    torch.cuda.synchronize()
    assert profiler.control("stop") == (200, None)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = [e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]]
    kernels = sum("quant_fused_kernel" in n for n in names)
    launches = sum(n == "cudaGraphLaunch" for n in names)
    assert kernels >= 5 or launches >= 5, (kernels, launches)


@pytest.mark.gpu
@pytest.mark.parametrize("tier_routing", [False, True])
def test_a_regrid_on_the_card_captures_only_the_new_buckets(card_state, fleet_dirs,
                                                            monkeypatch, tier_routing):
    """A hot regrid (1, 4, 8, 64) -> (1, 2, 3, 8, 64) on the quant tier (and
    the exact tier beside it with routing): the warm captures one graph
    per new bucket and tier, nothing is captured at a dispatch, a request
    whose bucket came from the old grid replays its old graph after the
    exchange, every quant answer is bitwise the pre-regrid one, and the
    rollback captures nothing."""
    from mlops_tpu_torch.autotune import apply_plan
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, _, ds, _ = card_state
    engine = InferenceEngine(load_bundle(fleet_dirs[0]), buckets=(1, 4, 8, 64),
                             serve_tier="quant", tier_routing=tier_routing)
    engine.warmup()
    captures = []
    capture = engine._capture
    monkeypatch.setattr(engine, "_capture", lambda *a: captures.append(a[1:]) or capture(*a))
    requests = [(ds.cat_ids[i:i + n], ds.numeric[i:i + n]) for i, n in
                ((0, 2), (10, 3), (20, 4), (30, 40))]
    want = [engine.fetch_arrays_raw(engine.dispatch_arrays(*r)) for r in requests]
    assert apply_plan(engine, (1, 2, 3, 8, 64)) == 2
    tiers = engine.available_tiers
    assert sorted(captures) == sorted((t, (b,)) for t in tiers for b in (2, 3))
    assert engine.swap_stats["graphs"] == 2 * len(tiers)
    assert engine.swap_stats["graph_pool_bytes"] >= 0
    captures.clear()
    got = [engine.fetch_arrays_raw(engine.dispatch_arrays(*r)) for r in requests]
    handle = engine.dispatch_arrays(*requests[1])
    assert handle.rows == 3
    engine.fetch_arrays_raw(handle)
    engine._bucket_for = lambda n: 4  # a stale read of the old grid
    raced = engine.fetch_arrays_raw(engine.dispatch_arrays(*requests[1]))
    del engine._bucket_for
    engine.rollback()
    rolled = [engine.fetch_arrays_raw(engine.dispatch_arrays(*r)) for r in requests]
    assert captures == [] and engine.grid_generation == 3
    for answers in (got, rolled):
        for w, g in zip(want, answers):
            for a, b in zip(w, g):
                assert np.array_equal(_bits(a), _bits(b))
    for a, b in zip(want[1], raced):
        assert np.array_equal(_bits(a), _bits(b))
    counts = engine.dispatch_counts()
    assert counts["bucket_2"] == 1 and counts["bucket_3"] == 2 and counts["bucket_4"] == 7


@pytest.mark.gpu
def test_a_primed_profiler_starts_at_once(card_state, tmp_path):
    """After ``prime`` (CUPTI initialized on this thread) a start answers in
    well under the ring front end's 10 s wait, and the trace lands on stop."""
    import time

    from mlops_tpu_torch.serve.server import TorchProfiler

    profiler = TorchProfiler(str(tmp_path))
    assert profiler.prime() > 0.0
    t0 = time.perf_counter()
    assert profiler.control("start") == (200, None)
    assert time.perf_counter() - t0 < 1.0
    torch.ones(8, device="cuda").sum().item()
    assert profiler.control("stop") == (200, None)
    assert list(tmp_path.glob("*.pt.trace.json"))


# ------------------------------------------------------------ the gbm tier
@pytest.fixture(scope="module")
def gbm_engines(tmp_path_factory):
    """The committed fixture's gbm bundle (``scripts/torch_gbm_fixture.py``:
    the job's 75 trees, built without scikit-learn), served by an engine
    on the card (CUDA graphs) and one on the CPU route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    from pathlib import Path

    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    script = Path(__file__).resolve().parent.parent / "scripts" / "torch_gbm_fixture.py"
    spec = importlib.util.spec_from_file_location("torch_gbm_fixture", script)
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    bundle_dir = fixture.fixture_bundle(tmp_path_factory.mktemp("gbm") / "bundle")
    card = InferenceEngine(load_bundle(bundle_dir), device="cuda")
    cpu = InferenceEngine(load_bundle(bundle_dir), device="cpu")
    card.warmup()
    cpu.warmup()
    return card, cpu, fixture.read_fixture()


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", SHAPES)
def test_the_gbm_tier_on_the_card_matches_its_cpu_route(gbm_engines, s, b):
    """Each bucket and group geometry's graph on the fixture's rows (3/4 of
    a bucket solo, ragged slots grouped): predictions bitwise equal to the
    CPU route and to scikit-learn's recorded probabilities, flags exact,
    drift within 1e-5."""
    card, cpu, data = gbm_engines
    rng = np.random.default_rng(s * 1000 + b)
    if s == 1:
        n = max(1, b - b // 4)
        lo = int(rng.integers(0, len(data["probs"]) - n))
        rows = np.arange(lo, lo + n)
        got, want = (e.fetch_arrays_raw(e.dispatch_arrays(data["cat_ids"][rows],
                                                          data["numeric"][rows]))
                     for e in (card, cpu))
        pairs = [(got, want, rows)]
    else:
        sizes = rng.integers(1, b + 1, size=s)
        starts = np.cumsum([0, *sizes[:-1]])
        parts = [(data["cat_ids"][o:o + n], data["numeric"][o:o + n])
                 for o, n in zip(starts, sizes)]
        got, want = (e.fetch_group_raw(e.dispatch_group_arrays(parts)) for e in (card, cpu))
        pairs = [((got[1][i, :n], got[2][i, :n], got[3][i]),
                  (want[1][i, :n], want[2][i, :n], want[3][i]), np.arange(o, o + n))
                 for i, (o, n) in enumerate(zip(starts, sizes))]
    for g, w, rows in pairs:
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[0].astype(np.float32), data["probs"][rows])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-5 + 1e-6)


@pytest.mark.gpu
def test_every_gbm_dispatch_on_the_card_is_a_graph_replay(gbm_engines):
    from mlops_tpu_torch.ops.gbm_tensor import gbm_graph_replays

    card, _, data = gbm_engines
    tier = card._tiers["gbm"]
    assert all(t.is_cuda for t in tier.params.values())
    assert tier.params["value"].dtype == tier.temperature.dtype == torch.float64
    assert len(card._graphs) == card.warmup_stats["programs"] == 16
    gbm_graph_replays.reset()
    before = sum(card.dispatch_counts().values())
    for n in (1, 5, 64, 200):
        card.fetch_arrays_raw(card.dispatch_arrays(data["cat_ids"][:n], data["numeric"][:n]))
    parts = [(data["cat_ids"][i:i + 2], data["numeric"][i:i + 2]) for i in range(0, 20, 2)]
    card.fetch_group_raw(card.dispatch_group_arrays(parts))
    assert gbm_graph_replays.value == sum(card.dispatch_counts().values()) - before == 5


# --------------------------------------- the rest of the transformer families
# The moe family, ensembles of transformer members and the BERT masked-LM
# on the card against the CPU, seeded with flax's initializers at small
# widths. Tolerances: bf16 serving programs as the exact tier's above
# (predictions 1.6e-2); a CUDA graph replay bitwise equal to the same
# program run eagerly on the card; one step's gradients per leaf within
# 1e-4 of the leaf's largest magnitude at f32 (TF32 off) and, at bf16,
# over the whole gradient at cosine 0.98 / norm 5 % (a token whose 2nd and
# 3rd gates are within the bf16 rounding of the router's input may route
# apart, which moves a few small leaves alone; test_torch_moe.py says
# more); the moe auxiliary 1e-3 relative; MLM logits at bf16 within 2e-2
# of the logits' largest magnitude and the masked loss within 1e-2
# relative, at f32 1e-4 and 1e-5.
A9_MODELS = {
    "moe": dict(family="moe", token_dim=32, depth=2, heads=4, num_experts=4),
    "moe-ens2": dict(family="moe", token_dim=32, depth=2, heads=4, num_experts=4,
                     ensemble_size=2),
    "ft-ens4": dict(family="ft_transformer", token_dim=32, depth=2, heads=4,
                    ensemble_size=4),
    "bert-ens2": dict(family="bert", token_dim=32, depth=2, heads=4, ensemble_size=2),
}


def _a9_model(name, precision="bf16", **extra):
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model, init_params

    kw = dict(A9_MODELS[name], precision=precision, **extra)
    return init_params(build_model(ModelConfig(**kw)), len(name))


def _a9_rows(n, seed):
    from mlops_tpu_torch.schema.features import SCHEMA

    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, n) for c in SCHEMA.cards], axis=-1).astype(np.int32)
    num = rng.normal(size=(n, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(n) < 0.3).astype(np.float32)
    return cat, num, lab


@pytest.mark.gpu
@pytest.mark.parametrize("s,b", [(1, 1), (1, 256), (64, 1), (64, 8)])
@pytest.mark.parametrize("name", sorted(A9_MODELS))
def test_a9_models_on_the_card_match_the_cpu_route(card_state, name, s, b):
    from mlops_tpu_torch.monitor.state import init_accumulator
    from mlops_tpu_torch.ops.predict import (
        make_packed_grouped_base,
        make_packed_predict_base,
        model_params,
        packed_layout,
    )

    _, mon, ds, dev = card_state
    cat, num, mask = _ks_edge_batch(ds, mon.num_ref_sorted, s, b, seed=s + b)
    outs = {}
    for device in ("cpu", dev):
        model = _a9_model(name).to(device).eval()
        program = (make_packed_predict_base if s == 1 else make_packed_grouped_base)(model)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (cat, num, mask)]
        if s == 1:
            inputs = [t[0] for t in inputs]
        with torch.inference_mode():
            packed, acc = program(model_params(model), mon.to(device),
                                  init_accumulator(device), torch.tensor(1.2, device=device),
                                  *inputs)
        outs[str(device)] = (packed.cpu(), acc)
    (got, got_acc), (want, want_acc) = outs["cuda"], outs["cpu"]
    p, _, d = packed_layout(b)
    assert (got[..., p] - want[..., p]).abs().max().item() <= 1.6e-2
    assert torch.equal(got[..., d].isnan(), want[..., d].isnan())
    assert float(got_acc.rows) == float(want_acc.rows)


@pytest.fixture(scope="module")
def a9_engines(card_state, tmp_path_factory):
    """A moe and an ft-ens4 bundle, each served by a graph engine and an
    eager one on the card."""
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, mon, ds, _ = card_state
    columns, _ = generate_synthetic(5000, seed=0)
    prep = Preprocessor.fit(columns)
    engines = {}
    for name in ("moe", "ft-ens4"):
        path = tmp_path_factory.mktemp(f"a9_{name}")
        save_exact_bundle(path, ModelConfig(precision="bf16", **A9_MODELS[name]),
                          _a9_model(name), prep, mon.to("cpu"),
                          calibration={"temperature": 1.2})
        bundle = load_bundle(path)
        graphs = InferenceEngine(bundle)
        eager = InferenceEngine(bundle, cuda_graphs=False)
        graphs.warmup()
        eager.warmup()
        engines[name] = (graphs, eager)
    return engines, ds


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["moe", "ft-ens4"])
def test_a9_graph_replays_are_bitwise_equal_to_the_eager_program(a9_engines, name):
    engines, ds = a9_engines
    graphs, eager = engines[name]
    assert graphs.warmup_stats["route"] == "cuda_graphs"
    assert graphs.warmup_stats["programs"] == len(graphs._graphs) == 16
    assert graphs.warmup_stats["graph_pool_bytes"] > 0
    keys = [(b,) for b in graphs.buckets] + [
        (s, r) for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS
    ]
    for k, key in enumerate(keys):
        got = _dispatch(graphs, ds, key, 10 * k + 3, "exact")
        want = _dispatch(eager, ds, key, 10 * k + 3, "exact")
        assert np.array_equal(_bits(got), _bits(want)), (name, key)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(A9_MODELS))
def test_a9_one_step_gradients_on_the_card_match_the_cpu(name, precision):
    from mlops_tpu_torch.train.loop import loss_of

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cat, num, lab = _a9_rows(256, seed=3)
    grads, losses, aux = {}, {}, {}
    for device in ("cpu", "cuda"):
        model = _a9_model(name, precision, dropout=0.0).to(device)
        out = model(*(torch.from_numpy(a).to(device) for a in (cat, num)), train=True)
        if isinstance(out, tuple):
            aux[device] = out[1].detach().double().cpu()
        loss = loss_of(out, torch.from_numpy(lab).to(device), 3.0)
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-2 * abs(losses["cpu"])
    if aux:
        torch.testing.assert_close(aux["cuda"], aux["cpu"], rtol=1e-3, atol=0)
    if precision == "f32":
        for k, want in grads["cpu"].items():
            got = grads["cuda"][k]
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), k
        return
    g = torch.cat([v.flatten() for v in grads["cuda"].values()])
    w = torch.cat([v.flatten() for v in grads["cpu"].values()])
    cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
    assert cos >= 0.98, cos
    assert abs(g.norm().item() / w.norm().item() - 1) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_the_masked_lm_on_the_card_matches_the_cpu(precision):
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import init_params
    from mlops_tpu_torch.train import pretrain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = ModelConfig(family="bert", token_dim=32, depth=2, heads=4, precision=precision,
                         dropout=0.0)
    cat, num, _ = _a9_rows(64, seed=5)
    outs = {}
    for device in ("cpu", "cuda"):
        mlm = init_params(pretrain.build_mlm(config), 0).to(device)
        mask = torch.from_numpy(pretrain.step_mask(0, 1, 64, mlm)).to(device)
        logits, targets = mlm(torch.from_numpy(cat).to(device), torch.from_numpy(num).to(device),
                              mask)
        outs[device] = (logits.detach().cpu(), targets.cpu(),
                        pretrain.masked_loss(logits, targets, mask).item())
    (gl, gt, gloss), (wl, wt, wloss) = outs["cuda"], outs["cpu"]
    assert torch.equal(gt, wt)
    tol = (2e-2, 1e-2) if precision == "bf16" else (1e-4, 1e-5)
    assert (gl - wl).abs().max().item() <= tol[0] * wl.abs().max().item()
    assert abs(gloss - wloss) <= tol[1] * abs(wloss)


# ------------------------------------------- multi-rank layouts at world 1
# The TP, PP and SP trainers on the card as one rank of an NCCL group
# (the one-rank group a plain run makes from a local store): the TP step
# equals the dense step bit for bit; GPipe and the ring agree with the
# dense trainer within the card-vs-CPU curve tolerance (0.05) and the
# gradients' cosine (>= 0.98), PERF.md §2.
A11_KW = dict(token_dim=16, depth=2, heads=2, num_experts=4)
A11_ROWS = 512


def _a11_batch(rows, seed, device):
    from mlops_tpu_torch.schema.features import SCHEMA

    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, c, rows) for c in SCHEMA.cards], axis=1).astype(np.int32)
    num = rng.normal(size=(rows, SCHEMA.num_numeric)).astype(np.float32)
    lab = (rng.random(rows) < 0.3).astype(np.float32)
    return (torch.from_numpy(cat).to(device), torch.from_numpy(num).to(device),
            torch.from_numpy(lab).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mlp", "ft_transformer", "bert", "moe"])
def test_a11_tp_step_is_the_dense_step_over_nccl(family):
    from mlops_tpu_torch.config import Config, ModelConfig, TrainConfig
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.train.loop import make_optimizer, train_step
    from mlops_tpu_torch.train.tensor_parallel import make_tp_trainer

    dev = _card()
    config = Config()
    kw = dict(hidden_dims=(64, 64), embed_dim=8) if family == "mlp" else A11_KW
    config.model = ModelConfig(family=family, dropout=0.1, tensor_parallel=1, **kw)
    config.train = TrainConfig(batch_size=64, steps=100, warmup_steps=2)
    dense = init_params(build_model(ModelConfig(family=family, dropout=0.1, **kw)), 0).to(dev)
    opt = make_optimizer(dense, config.train)
    tp = make_tp_trainer(config, device=dev)
    cat, num, lab = _a11_batch(64, 1, dev)
    for step in range(1, 6):
        want = train_step(dense, opt, config.train, step, cat, num, lab)
        got = tp.step.step(step, cat, num, lab)
        assert torch.equal(got, want), step
    params = tp.step.gather(tp.step.params())
    for name, p in dense.named_parameters():
        assert torch.equal(params[name], p.detach()), name


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bert", "ft_transformer"])
def test_a11_pp_step_follows_the_dense_trainer_over_nccl(family):
    from mlops_tpu_torch.config import ModelConfig, TrainConfig
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.parallel.distributed import initialize
    from mlops_tpu_torch.parallel.mesh import make_nd_mesh
    from mlops_tpu_torch.train.loop import make_optimizer, train_step
    from mlops_tpu_torch.train.pipeline_parallel import make_pp_train_step
    from mlops_tpu_torch.weights import load_params

    dev = _card()
    initialize(dev)
    mcfg = ModelConfig(family=family, dropout=0.0, pipeline_stages=1, **A11_KW)
    tcfg = TrainConfig(batch_size=64, steps=100, warmup_steps=2, pipeline_microbatches=4)
    dense_cfg = ModelConfig(family=family, dropout=0.0, **A11_KW)
    init = init_params(build_model(dense_cfg), 0).state_dict()
    dense = load_params(build_model(dense_cfg), init).to(dev)
    opt = make_optimizer(dense, tcfg)
    pp = make_pp_train_step(mcfg, tcfg, make_nd_mesh({"data": 1, "stage": 1}), init_state=init,
                            device=dev)
    cat, num, lab = _a11_batch(64, 2, dev)
    for step in range(1, 6):
        want = train_step(dense, opt, tcfg, step, cat, num, lab)
        got = pp.step(step, cat, num, lab)
        assert abs(got.item() - want.item()) <= 0.05, step
    merged = pp.dense_params()
    g = torch.cat([merged[k].flatten() for k, _ in dense.named_parameters()])
    w = torch.cat([p.detach().flatten() for p in dense.parameters()])
    assert torch.nn.functional.cosine_similarity(g - torch.cat(
        [v.flatten().to(dev) for v in init.values()]), w - torch.cat(
        [v.flatten().to(dev) for v in init.values()]), dim=0).item() >= 0.98


@pytest.mark.gpu
def test_a11_ring_on_one_rank_is_dense_attention_over_nccl():
    from mlops_tpu_torch.parallel.distributed import initialize
    from mlops_tpu_torch.parallel.mesh import make_nd_mesh
    from mlops_tpu_torch.parallel.ring_attention import make_ring_attention

    dev = _card()
    initialize(dev)
    ring = make_ring_attention(make_nd_mesh({"data": 1, "seq": 1}), "seq")
    q, k, v = (torch.randn(2, 64, 2, 16, device=dev, generator=torch.Generator(dev).manual_seed(i))
               for i in range(3))
    want = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0, dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", want, v)
    torch.testing.assert_close(ring(q, k, v), want, rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
def test_a11_tune_and_score_over_a_one_rank_data_mesh_equal_no_mesh(tmp_path):
    """The data mesh of ``tune``, ``score-batch`` and the streamed scorer
    as one NCCL rank (``make_mesh()`` given explicitly; the commands build
    one only past a rank, as the JAX command does) against ``mesh=None``:
    the same sweep, bit for bit the same scores."""
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.config import Config, HPOConfig, ModelConfig, TrainConfig
    from mlops_tpu_torch.data import write_csv_columns
    from mlops_tpu_torch.data.stream import score_csv_stream
    from mlops_tpu_torch.parallel.bulk import score_dataset
    from mlops_tpu_torch.parallel.distributed import initialize
    from mlops_tpu_torch.parallel.mesh import make_mesh
    from mlops_tpu_torch.train.pipeline import run_tuning

    dev = _card()
    initialize(dev)
    mesh = make_mesh()
    runs = {}
    for name, m in (("mesh", mesh), ("none", None)):
        config = Config()
        config.model = ModelConfig(family="mlp", hidden_dims=(32, 32), embed_dim=4)
        config.train = TrainConfig(batch_size=128)
        config.hpo = HPOConfig(trials=3, steps=20)
        config.data.rows = 3000
        config.registry.root = str(tmp_path / name / "reg")
        config.registry.run_root = str(tmp_path / name / "runs")
        runs[name] = run_tuning(config, run_name="t", mesh=m)
    (res_m, hpo_m), (res_n, hpo_n) = runs["mesh"], runs["none"]
    assert hpo_m.best_index == hpo_n.best_index
    assert hpo_m.trials == hpo_n.trials
    for k, v in hpo_n.best_params.items():
        assert torch.equal(hpo_m.best_params[k], v), k
    bundle = load_bundle(res_n.bundle_dir)
    columns, labels = generate_synthetic(5000, seed=3)
    ds = bundle.preprocessor.encode(columns)
    got, want = (score_dataset(bundle, ds, chunk_rows=1024, device=dev, mesh=m)
                 for m in (mesh, None))
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.outliers, want.outliers)
    assert got.feature_drift == want.feature_drift
    source = tmp_path / "rows.csv"
    write_csv_columns(source, columns, labels)
    for name, m in (("mesh", mesh), ("none", None)):
        score_csv_stream(bundle, source, tmp_path / f"{name}.csv", chunk_rows=1024, device=dev,
                         mesh=m)
    assert (tmp_path / "mesh.csv").read_bytes() == (tmp_path / "none.csv").read_bytes()


# ------------------------------------------- sharded serving at world 1
# serve.model_shards over a one-rank ('model',) mesh of an NCCL group:
# every captured graph holds the NCCL calls its layout implies (one per
# row cut and per split mixture of experts), each replay makes them, and
# the answers equal the unsharded engine's bit for bit.
A11B_KW = {"mlp": dict(hidden_dims=(64, 64), embed_dim=8),
           "bert": dict(token_dim=16, depth=2, heads=2),
           "moe": dict(token_dim=16, depth=1, heads=2, num_experts=4)}


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(A11B_KW))
def test_a11b_one_rank_sharded_graphs_hold_nccl_and_equal_the_unsharded_engine(
        card_state, tmp_path, family):
    from mlops_tpu_torch.bundle import load_bundle, save_exact_bundle
    from mlops_tpu_torch.config import ModelConfig
    from mlops_tpu_torch.models import build_model, init_params
    from mlops_tpu_torch.parallel.collectives import COLLECTIVE_CALLS
    from mlops_tpu_torch.parallel.distributed import initialize
    from mlops_tpu_torch.parallel.sharding import serve_mesh
    from mlops_tpu_torch.serve.engine import InferenceEngine

    _, mon, ds, dev = card_state
    initialize(dev)
    columns, _ = generate_synthetic(5000, seed=0)
    config = ModelConfig(family=family, precision="bf16", **A11B_KW[family])
    save_exact_bundle(tmp_path, config, init_params(build_model(config), 3),
                      Preprocessor.fit(columns), mon.to("cpu"),
                      calibration={"temperature": 1.2})
    bundle = load_bundle(tmp_path)
    sharded = InferenceEngine(bundle, mesh=serve_mesh(1, 0, "cuda"))
    plain = InferenceEngine(bundle)
    sharded.warmup()
    per_graph = {g.collectives for g in sharded._graphs.values()}
    assert len(per_graph) == 1 and per_graph.pop() > 0
    for seed, key in enumerate([(1,), (8,), (64,), (256,), (16, 8), (64, 1)]):
        graph = sharded._graphs[("exact", key)]
        before = COLLECTIVE_CALLS.value
        got = _dispatch(sharded, ds, key, seed, None)
        assert COLLECTIVE_CALLS.value - before == graph.collectives
        want = _dispatch(plain, ds, key, seed, None)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.array_equal(_acc_bits(sharded), _acc_bits(plain))
