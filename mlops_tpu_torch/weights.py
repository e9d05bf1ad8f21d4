"""Carry serving state across from the JAX package as numpy.

The tests feed both packages identical state: they take the JAX package's
quant params and monitor arrays as numpy (``np.asarray`` of its leaves, or
the arrays its npz files hold) and hand them to these functions, which
return the port's tensors on ``device``. bf16 leaves arrive either as the
f32 image the npz holds or as an ml_dtypes bfloat16 array; both map to the
same bf16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from mlops_tpu_torch.monitor.state import MonitorState
from mlops_tpu_torch.ops.quant import quant_params_from_arrays

_QUANT_KEYS = {"embed", "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2"}


def quant_params_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> dict[str, torch.Tensor]:
    """Quant param arrays -> the port's dict of tensors on ``device``."""
    if set(arrays) != _QUANT_KEYS:
        raise KeyError(
            f"quant params must hold {sorted(_QUANT_KEYS)}, got {sorted(arrays)}"
        )
    # bf16 embed: widening to f32 is exact, and quant_params_from_arrays
    # narrows it back to the same bits.
    host = {
        k: np.asarray(v, np.float32) if k == "embed" else np.asarray(v)
        for k, v in arrays.items()
    }
    return {k: v.to(device) for k, v in quant_params_from_arrays(host).items()}


def monitor_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str
) -> MonitorState:
    """Monitor arrays (``MonitorState.to_arrays`` of either package) -> the
    port's ``MonitorState`` on ``device``."""
    return MonitorState.from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}
    ).to(device)
