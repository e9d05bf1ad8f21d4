"""The port's flash-attention backward against the JAX package's, on the
CPU.

Inputs are made by numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it off the TPU: ``_flash_forward``
then ``_flash_backward`` with ``interpret=True`` and 64-row blocks, so
S = 128, 140 and 200 walk several blocks and a padded, masked tail.
Tolerances:

- f32: 5e-5 absolute plus 1e-4 of the gradient's largest magnitude, the
  JAX package's own tolerance for ragged flash gradients
  (``tests/test_attention.py``): the same f32 arithmetic in another
  summation order (measured worst 8e-7);
- bf16: two bf16 ulps at the gradient's largest magnitude (both sides
  round ds and p to bf16 from f32 values that differ in the last bits,
  and round each f32 sum once; measured worst one ulp);
- the Function against autograd through ``reference_attention`` at f32:
  2e-6 absolute (the same function; measured worst 5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlops_tpu.ops import attention as jax_attention
from mlops_tpu_torch.ops import attention

SHAPES = [  # (B, S_q, S_kv, H, D)
    (2, 128, 128, 4, 32),
    (1, 200, 200, 2, 16),
    (2, 24, 24, 2, 8),
    (2, 45, 70, 2, 32),
    (4, 140, 140, 2, 16),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FUNCTION_TOL = 2e-6


def _grad_tol(want: np.ndarray, dtype: str) -> float:
    big = float(np.abs(want).max())
    if dtype == "bf16":
        return 2 * 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7)
    return 5e-5 + 1e-4 * big


def _arrays(b, s_q, s_kv, h, d, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(b, s, h, d)).astype(np.float32)
        for s in (s_q, s_kv, s_kv, s_q)
    ]  # q, k, v, do


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_backward_plain_version_matches_jax_interpret_kernels(b, s_q, s_kv, h, d, dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = _arrays(b, s_q, s_kv, h, d, seed=s_kv + d)
    scale = 1.0 / np.sqrt(d)

    def jax_grads(q, k, v, do):  # one jit: faster than op-by-op interpret
        out, lse = jax_attention._flash_forward(q, k, v, scale, 64, 64, interpret=True)
        return jax_attention._flash_backward(
            q, k, v, out, lse, do, scale, 64, 64, interpret=True
        )

    want = jax.jit(jax_grads)(*(jnp.asarray(a, jdt) for a in arrays))
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    t_out, t_lse = attention.flash_forward_reference(q, k, v, scale)
    got = attention.flash_backward_reference(q, k, v, t_out, t_lse, do, scale)
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        w = np.asarray(w, np.float32)
        assert g.dtype == tdt and g.shape == like.shape, name
        assert np.abs(g.float().numpy() - w).max() <= _grad_tol(w, dtype), name


@pytest.mark.parametrize(
    "b,s_q,s_kv,h,d", [(2, 128, 128, 2, 16), (2, 45, 70, 2, 32), (1, 140, 140, 2, 8)]
)
def test_function_gradients_equal_autograd_through_the_dense_reference(b, s_q, s_kv, h, d):
    arrays = _arrays(b, s_q, s_kv, h, d, seed=3 * s_q + d)
    grads = {}
    for route in ("flash", "dense"):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
        out = attention.attend(q, k, v, use_flash=route == "flash")
        out.backward(torch.from_numpy(arrays[3]))
        grads[route] = (out.detach(), q.grad, k.grad, v.grad)
    for name, got, want in zip(("out", "dq", "dk", "dv"), grads["flash"], grads["dense"]):
        assert (got - want).abs().max().item() <= FUNCTION_TOL, name


def test_function_passes_gradcheck_at_f64():
    rng = np.random.default_rng(5)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(1, s, 2, 4))).requires_grad_()
        for s in (5, 7, 7)
    )
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention.flash_attention(a, b, c), (q, k, v)
    )


def test_flash_route_goes_through_the_function_and_saves_nothing_without_grad():
    arrays = _arrays(2, 140, 140, 2, 16, seed=1)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    before = attention.flash_kernel_launches.value
    for out in (
        attention.flash_attention(q, k, v),
        attention.attend(q, k, v, use_flash=True),
    ):
        assert isinstance(out.grad_fn, attention.FlashAttention._backward_cls)
    with torch.inference_mode():
        assert attention.attend(q, k, v, use_flash=True).grad_fn is None
    with torch.no_grad():
        assert attention.flash_attention(q, k, v).grad_fn is None
    plain = attention.flash_attention(*(t.detach() for t in (q, k, v)))
    assert plain.grad_fn is None
    assert torch.equal(plain, attention.flash_forward_reference(q, k, v)[0].detach())
    # The dense route stays plain autograd; nothing launched on the CPU.
    assert not isinstance(
        attention.attend(q, k, v, use_flash=False).grad_fn,
        attention.FlashAttention._backward_cls,
    )
    assert attention.flash_kernel_launches.value == before


def test_backward_wrappers_take_only_cuda_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 130, 130, 2, 16, seed=2))
    lse = torch.zeros(2, 130)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.flash_bwd_dq_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.flash_bwd_dkv_cuda(q, k, v, do, lse, lse)
