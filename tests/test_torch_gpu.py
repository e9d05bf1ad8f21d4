"""The CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: without a CUDA card every case skips (the kernel has no
CPU mode). This file imports torch and the port only, so it also runs on
a machine without JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerances: categorical counts and K-S statistics exact (integer counts,
correctly rounded f32 divisions), predictions 1e-6 absolute, flags exact
except rows within 1e-5 x threshold of it.
"""

import numpy as np
import pytest
import torch

from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.ops import quant_kernel
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
