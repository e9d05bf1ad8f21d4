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
    q, k, v = _qkv(2, 24, 24, 2, 8, torch.float32, dev, seed=0)
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
