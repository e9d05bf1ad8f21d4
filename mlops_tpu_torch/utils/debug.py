"""Numeric sanitizers: the port's counterpart of the JAX package's
``utils/debug.py`` (``checkify``'s float checks).

The hazard class is numeric: NaN/Inf escaping an op or a kernel into the
predictions, or an out-of-range categorical id gathering a wrong
embedding row. ``checked(fn)`` runs ``fn`` under a ``TorchDispatchMode``
that tests every floating output of every aten op for NaN/Inf, and hands
every hand-written kernel's outputs to the same test
(``ops/cuda_build.kernel_output_observer``), its operands too (a kernel
is opaque: a NaN it reads need not reach its outputs); the first op or
kernel that failed is named in the ``NumericCheckError``. A NaN fails wherever
it appears; an Inf fails where an op made it from finite operands (an
infinite sentinel such as ``full_like(x, inf)`` passes, as ``checkify``'s
float checks let infinities through).

The tests run on the device that computes them and are read back with
one host synchronization at the end of the call, so a checked call
changes no value it computes: its outputs are bitwise the unchecked
call's. On CUDA tensors the kernels launch as they would unchecked; the
checker never moves work to the plain version or to the CPU. Opt-in
(debug, the ``analyze --numeric`` audit), never on the serving path: the
extra reductions cost a launch per op.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mlops_tpu_torch.ops.cuda_build import kernel_output_observer
from mlops_tpu_torch.schema.features import SCHEMA

# Ops whose outputs are uninitialized memory (a kernel's output buffers
# before the launch writes them): nothing to test.
_UNINITIALIZED = frozenset({
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.new_empty.default", "aten.new_empty_strided.default",
    "aten.empty_like.default", "aten.resize_.default", "aten.set_.source_Storage",
})


class NumericCheckError(RuntimeError):
    """A NaN or Inf came out of ``op`` (an aten op's name, or ``kernel
    <name>`` for a hand-written kernel)."""

    def __init__(self, op: str, position: int, total: int) -> None:
        self.op = op
        super().__init__(
            f"non-finite value (NaN/Inf) produced by {op} "
            f"(check {position + 1} of {total} in this call)"
        )


class _FiniteChecks(TorchDispatchMode):
    """Records, per floating output, a device-side flag and the op that
    produced it. A NaN fails wherever it appears (the first op that
    outputs one is named, a planted NaN included); an Inf fails only
    where an op made it from finite operands, so an infinite sentinel
    (``full_like(x, inf)``, a masked fill) and its copies pass, as
    ``checkify``'s float checks let infinities through."""

    def __init__(self) -> None:
        super().__init__()
        self.flags: list[torch.Tensor] = []
        self.sources: list[str] = []

    def note(self, source: str, outputs, inputs=None) -> None:
        """``inputs``: the op's operands, None for a kernel (whose
        operands the observer does not see: any Inf fails)."""
        carried = False  # an operand was already infinite or NaN
        device_finite: list[torch.Tensor] = []  # operands' flags on a device
        if inputs is not None:
            for a in tree_flatten(inputs)[0]:
                if isinstance(a, float):
                    carried |= not math.isfinite(a)
                elif isinstance(a, torch.Tensor) and a.is_floating_point() and a.numel():
                    if a.device.type == "cpu":  # a host operand: read at once
                        carried |= not bool(torch.isfinite(a).all())
                    else:
                        device_finite.append(torch.isfinite(a).all())
        for t in tree_flatten(outputs)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                ok = ~torch.isnan(t).any()
                if not carried:
                    no_inf = ~torch.isinf(t).any()
                    if device_finite:  # an Inf passes when an operand had one
                        made = torch.stack([f.to(t.device) for f in device_finite]).all()
                        no_inf = no_inf | ~made
                    ok = ok & no_inf
                self.flags.append(ok.reshape(1))
                self.sources.append(source)

    def note_kernel(self, name: str, outputs, inputs) -> None:
        """A hand-written kernel is opaque: a NaN among its operands fails
        at it (its outputs need not carry one), and its outputs are
        tested as an op's are."""
        for t in inputs:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                self.flags.append((~torch.isnan(t).any()).reshape(1))
                self.sources.append(f"kernel {name} (an operand)")
        self.note(f"kernel {name}", outputs, inputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        if name not in _UNINITIALIZED:
            self.note(name, out, (args, kwargs))
        return out

    def first_failure(self) -> tuple[str, int] | None:
        """The first (source, position) whose output was not finite: one
        host synchronization over all the flags."""
        if not self.flags:
            return None
        by_device: dict[torch.device, list[int]] = {}
        for i, flag in enumerate(self.flags):
            by_device.setdefault(flag.device, []).append(i)
        bad: list[int] = []
        for device, positions in by_device.items():
            ok = torch.cat([self.flags[i] for i in positions]).cpu()
            bad += [positions[j] for j in np.flatnonzero(~ok.numpy())]
        if not bad:
            return None
        first = min(bad)
        return self.sources[first], first


def checked(fn: Callable) -> Callable:
    """``fn`` with float checks: the wrapped callable has ``fn``'s
    signature and raises ``NumericCheckError``, naming the aten op or the
    kernel, when any of them produced a NaN or Inf."""

    def run(*args, **kwargs):
        mode = _FiniteChecks()
        with kernel_output_observer(mode.note_kernel):
            with mode:
                out = fn(*args, **kwargs)
        failure = mode.first_failure()
        if failure is not None:
            raise NumericCheckError(failure[0], failure[1], len(mode.flags))
        return out

    return run


def _host(array: Any) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def check_encoded_inputs(cat_ids: Any, numeric: Any) -> None:
    """Validate an encoded batch before it reaches a kernel: categorical
    ids must be inside every embedding table (OOV bucket included) and
    numerics finite. Host-side, with the JAX package's messages."""
    cat = _host(cat_ids)
    cards = np.asarray(SCHEMA.cards)
    if cat.ndim != 2 or cat.shape[1] != SCHEMA.num_categorical:
        raise ValueError(f"cat_ids shape {cat.shape} != (N, {SCHEMA.num_categorical})")
    if (cat < 0).any() or (cat >= cards[None, :]).any():
        j = int(np.argwhere((cat < 0) | (cat >= cards[None, :]))[0][1])
        raise ValueError(
            f"categorical id out of range for feature "
            f"{SCHEMA.categorical[j].name!r} (card {cards[j]})"
        )
    num = _host(numeric)
    if num.shape != (cat.shape[0], SCHEMA.num_numeric):
        raise ValueError(
            f"numeric shape {num.shape} != ({cat.shape[0]}, {SCHEMA.num_numeric})"
        )
    if not np.isfinite(num).all():
        raise ValueError("non-finite value in encoded numerics")
