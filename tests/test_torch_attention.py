"""The port's attention against the JAX package's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages. The
JAX flash forward runs as its own tests run it off the TPU: the Pallas
kernel in interpret mode (``_flash_forward(..., interpret=True)``), here
with 64-row blocks so that S = 128, 140 and 200 walk several k blocks and
a padded, masked tail. Tolerances:

- f32: out 2e-5, lse 1e-5 (the same f32 arithmetic in another summation
  order);
- bf16: out 2e-2 (two bf16 ulps at |out| near 1; JAX's bf16 flash output
  and its dense reference differ by one ulp, 0.0078, at this size), lse
  1e-3 (lse is f32 in both; the inputs are the same bf16 values).
"""

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
DTYPES = {
    "f32": (jnp.float32, torch.float32, 2e-5, 1e-5),
    "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-3),
}


def _inputs(b, s_q, s_kv, h, d, dtype, seed):
    jdt, tdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(seed)
    arrays = [
        rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (s_q, s_kv, s_kv)
    ]
    return (
        [jnp.asarray(a, jdt) for a in arrays],
        [torch.from_numpy(a).to(tdt) for a in arrays],
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_flash_plain_version_matches_jax_interpret_kernel(b, s_q, s_kv, h, d, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, s_q, s_kv, h, d, dtype, seed=s_q + d)
    scale = 1.0 / np.sqrt(d)
    want_out, want_lse = jax_attention._flash_forward(
        jq, jk, jv, scale, 64, 64, interpret=True
    )
    out, lse = attention.flash_forward_reference(q, k, v, scale)
    _, _, out_tol, lse_tol = DTYPES[dtype]
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, s_q, h, d)
    assert lse.shape == (b * h, s_q) and lse.dtype == torch.float32
    assert np.abs(_np(out) - _np(want_out)).max() <= out_tol
    assert np.abs(_np(lse) - _np(want_lse)[:, :s_q]).max() <= lse_tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_reference_attention_matches_jax(b, s_q, s_kv, h, d, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, s_q, s_kv, h, d, dtype, seed=7 * s_q + d)
    want = jax_attention.reference_attention(jq, jk, jv)
    got = attention.reference_attention(q, k, v)
    assert got.dtype == DTYPES[dtype][1]
    assert np.abs(_np(got) - _np(want)).max() <= DTYPES[dtype][2]


def test_attend_routes_to_the_plain_versions_on_the_cpu():
    _, (q, k, v) = _inputs(2, 140, 140, 2, 16, "f32", seed=1)
    before = attention.flash_kernel_launches.value
    # S >= 128 on the CPU: the dense reference, as the JAX rule off the TPU.
    assert torch.equal(attention.attend(q, k, v), attention.reference_attention(q, k, v))
    forced = attention.attend(q, k, v, use_flash=True)
    assert torch.equal(forced, attention.flash_forward_reference(q, k, v)[0])
    assert torch.equal(
        attention.attend(q, k, v, use_flash=False),
        attention.reference_attention(q, k, v),
    )
    assert attention.flash_kernel_launches.value == before


def test_flash_wrapper_takes_only_cuda_tensors():
    _, (q, k, v) = _inputs(1, 130, 130, 2, 16, "bf16", seed=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.flash_forward_cuda(q, k, v)
    with pytest.raises(ValueError, match="do not fit"):
        attention.flash_attention(q, k[:, :, :1], v)
