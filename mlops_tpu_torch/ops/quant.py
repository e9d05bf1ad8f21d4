"""Int8/bf16 quantized student (port of the JAX package's ``ops/quant.py``).

A two-layer MLP student stored quantized:

- dense kernels: int8 weights + per-output-channel f32 scales
  (symmetric, scale = max|w| / 127 per column);
- embedding tables: bf16, stacked ``[C, max_card, E]``;
- biases: f32.

Compute dequantizes and runs f32. The bundle's ``quant_params.npz`` holds
the embed as the exact f32 image of its bf16 values (numpy has no bf16),
so loading casts it back to the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mlops_tpu_torch.schema.features import SCHEMA

QUANT_EMBED_DIM = 4
QUANT_HIDDEN = 32

# Manifest format tag: a loader refuses a quant blob written by a
# different packing scheme.
QUANT_FORMAT = "int8-dense/bf16-embed/v1"


def quantize_dense(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of a dense kernel
    ``[in, out]`` -> ``(int8 [in, out], f32 scales [out])``. All-zero
    columns get scale 1 (dequant stays exact)."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_dense(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 kernel + per-column scales -> f32 kernel."""
    return w_q.float() * scale[None, :]


def quantize_student(master: dict[str, Any]) -> dict[str, torch.Tensor]:
    """f32 master (numpy or tensors) -> the quantized serving dict. The
    head vector ``w2`` quantizes as a 1-column kernel."""
    host = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in master.items()
    }
    w1_q, w1_s = quantize_dense(host["w1"])
    w2_q, w2_s = quantize_dense(host["w2"][:, None])
    return {
        "embed": torch.from_numpy(host["embed"].astype(np.float32)).to(
            torch.bfloat16
        ),
        "w1_q": torch.from_numpy(w1_q),
        "w1_s": torch.from_numpy(w1_s),
        "b1": torch.from_numpy(host["b1"].astype(np.float32)),
        "w2_q": torch.from_numpy(np.ascontiguousarray(w2_q[:, 0])),
        "w2_s": torch.from_numpy(w2_s[0:1].reshape(())),
        "b2": torch.tensor(float(host["b2"]), dtype=torch.float32),
    }


def quant_params_geometry(qparams: dict[str, Any]) -> tuple[int, int]:
    """(embed_dim, hidden) read back from a quant dict."""
    return int(qparams["embed"].shape[2]), int(qparams["w1_q"].shape[1])


def init_quant_master(
    seed: int = 0,
    embed_dim: int = QUANT_EMBED_DIM,
    hidden: int = QUANT_HIDDEN,
) -> dict[str, torch.Tensor]:
    """Seeded f32 master weights at the student's geometry (the same
    scales as the JAX package's init; the numbers differ, because the
    random streams do)."""
    c, k = SCHEMA.num_categorical, max(SCHEMA.cards)
    d_in = c * embed_dim + SCHEMA.num_numeric
    gen = torch.Generator().manual_seed(seed)
    return {
        "embed": 0.02 * torch.randn((c, k, embed_dim), generator=gen),
        "w1": torch.randn((d_in, hidden), generator=gen) / np.sqrt(d_in),
        "b1": torch.zeros((hidden,)),
        "w2": torch.randn((hidden,), generator=gen) / np.sqrt(hidden),
        "b2": torch.zeros(()),
    }


def one_hot_2d(ids_col: torch.Tensor, k: int) -> torch.Tensor:
    """One-hot of an id column ``[..., N]`` -> f32 ``[..., N, k]``. Ids
    outside ``[0, k)`` give an all-zero row."""
    iota = torch.arange(k, device=ids_col.device)
    return (ids_col[..., None] == iota).float()


def student_logits(
    embed: torch.Tensor,  # [C, K, E] any float dtype (cast to f32)
    w1: torch.Tensor,  # f32 [C*E + M, H]
    b1: torch.Tensor,  # f32 [H]
    w2: torch.Tensor,  # f32 [H]
    b2: torch.Tensor,  # f32 []
    cat_ids: torch.Tensor,  # int32 [..., N, C]
    numeric: torch.Tensor,  # f32 [..., N, M]
) -> torch.Tensor:
    """The student forward, f32 end to end: per-feature one-hot embed
    matmuls -> concat with numerics -> dense/relu/dense. Returns logits
    ``[..., N]``."""
    c, k = embed.shape[0], embed.shape[1]
    feats = [
        one_hot_2d(cat_ids[..., j], k) @ embed[j].float() for j in range(c)
    ]
    x = torch.cat(feats + [numeric.float()], dim=-1)
    h = torch.relu(x @ w1 + b1)
    return h @ w2 + b2


def master_student_logits(
    master: dict[str, torch.Tensor],
    cat_ids: torch.Tensor,
    numeric: torch.Tensor,
) -> torch.Tensor:
    """Forward through the un-quantized f32 master, differentiable: the
    surface the quant student's distillation fit descends."""
    return student_logits(
        master["embed"], master["w1"], master["b1"], master["w2"],
        master["b2"], cat_ids, numeric,
    )


def quant_student_logits(
    qparams: dict[str, torch.Tensor],
    cat_ids: torch.Tensor,
    numeric: torch.Tensor,
) -> torch.Tensor:
    """Forward through the quantized dict: dequantize, then the shared f32
    forward."""
    w1 = dequantize_dense(qparams["w1_q"], qparams["w1_s"])
    w2 = qparams["w2_q"].float() * qparams["w2_s"]
    return student_logits(
        qparams["embed"], w1, qparams["b1"], w2, qparams["b2"],
        cat_ids, numeric,
    )


def quant_params_to_arrays(
    qparams: dict[str, torch.Tensor],
) -> dict[str, np.ndarray]:
    """npz-safe host arrays: the bf16 embed ships as its exact f32 image."""
    out = {}
    for key, leaf in qparams.items():
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        out[key] = leaf.numpy()
    return out


def quant_params_from_arrays(
    arrays: dict[str, np.ndarray],
) -> dict[str, torch.Tensor]:
    """Inverse of ``quant_params_to_arrays`` (embed goes back to bf16)."""
    out = {}
    for key, arr in arrays.items():
        tensor = torch.from_numpy(np.array(arr, copy=True))
        out[key] = tensor.to(torch.bfloat16) if key == "embed" else tensor
    return out
