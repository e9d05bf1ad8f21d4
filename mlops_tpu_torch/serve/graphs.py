"""One CUDA graph per warmed serving program.

The port's counterpart of the JAX package's ``compilecache/warmup.py``
serve entries (``serve_predict_jobs``, ``serve_group_jobs``,
``serve_quant_jobs``, ``serve_quant_group_jobs``): there, warmup makes
every serving shape one compiled executable before traffic; here,
``InferenceEngine.warmup`` captures every shape's packed program (model,
flags, drift, accumulator fold, and on the quant tier the
``quant_fused`` launch) into one ``torch.cuda.CUDAGraph``, so a dispatch
is one graph launch instead of a few hundred kernel launches.

A graph replays into fixed memory. Each captured program therefore reads
one static input buffer (``split_inputs``: the padded batch's int32
categoricals, f32 numerics and bool mask, packed into one byte buffer so
a dispatch uploads it with one copy), writes one static output, and
folds into the engine's one static accumulator in place. The engine
keeps overlapped dispatches apart by doing all of a dispatch's device
work under its lock on one stream: the upload into the static inputs,
the replay, and the copy of the static output into the dispatch's own
pinned host buffer. Stream order then keeps the next replay from
overwriting an output before it is copied. All graphs share one memory
pool; that is safe because they never run concurrently (one stream) and
each output is copied out before the next replay. Captures run on a
second stream of the engine's (``capture``), ordered with the replays by
the lock and two stream waits.

Host-side work that a capture skips is accounted for here: a kernel
wrapper's launch counter counts a launch recorded into a graph under
``captured`` (``ops/cuda_build.LaunchCounter``), and ``ServingGraph.replay``
adds the captured count to the counter at every replay. The gbm tier
launches no hand-written kernel; its graphs count their replays
(``ops/gbm_tensor.gbm_graph_replays``). A sharded engine's graphs hold
the NCCL calls of its layers' collectives, counted the same way
(``parallel/collectives.COLLECTIVE_CALLS``; ``ServingGraph.collectives``).

Nothing here depends on a tier's temperature or parameter dtypes: they
are the tier's own tensors, read by the captured program (the gbm tier's
f64 trees and temperature among them); only the batch is staged.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from mlops_tpu_torch.ops.cuda_build import LAUNCH_COUNTERS
from mlops_tpu_torch.schema.features import SCHEMA

_C = SCHEMA.num_categorical
_M = SCHEMA.num_numeric

# tpulint (analysis/astrules.py), read from this source and never
# imported. The factories whose returned programs run inside a capture
# (``capture`` here, the engine's warmup): Layer 1's captured scope.
TPULINT_CAPTURED = (
    "ops/predict.py::make_packed_predict_base",
    "ops/predict.py::make_packed_grouped_base",
    "ops/quant_kernel.py::make_quant_packed_base",
    "ops/quant_kernel.py::make_quant_grouped_base",
    "ops/gbm_tensor.py::make_gbm_packed_base",
    "ops/gbm_tensor.py::make_gbm_grouped_base",
    "parallel/bulk.py::make_bulk_fused",
    "parallel/bulk.py::make_bulk_quant_fused",
)
# The factories under serve/ and parallel/ whose program sites go through
# this module and ops/cuda_build.py (TPU203's routing): the bulk chunk
# scorer dispatches the programs above.
TPULINT_ROUTED_FACTORIES = ("make_chunk_scorer",)


def input_nbytes(lead: tuple[int, ...]) -> int:
    """Bytes of one packed batch of ``lead`` rows (``(B,)`` solo, ``(S,
    R)`` grouped): int32 [*lead, C] ‖ f32 [*lead, M] ‖ bool [*lead]."""
    n = math.prod(lead)
    return n * (4 * _C + 4 * _M + 1)


def _split(buf, lead: tuple[int, ...], view: Callable) -> tuple:
    n = math.prod(lead)
    a, b = 4 * n * _C, 4 * n * (_C + _M)
    return (
        view(buf[:a], "int32").reshape(*lead, _C),
        view(buf[a:b], "float32").reshape(*lead, _M),
        view(buf[b:b + n], "bool").reshape(lead),
    )


def split_inputs(buf: torch.Tensor, lead: tuple[int, ...]) -> tuple[torch.Tensor, ...]:
    """``(cat_ids, numeric, mask)`` views of a packed uint8 tensor."""
    return _split(buf, lead, lambda t, dtype: t.view(getattr(torch, dtype)))


def split_host(buf: np.ndarray, lead: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """The same views of a packed uint8 host array (a pinned tensor's
    ``numpy()``), for filling a batch in place."""
    return _split(buf, lead, lambda a, dtype: a.view(dtype))


class ServingGraph:
    """One captured packed program: its graph, static input buffer and
    static output, and the kernel launches one replay makes per launch
    counter."""

    __slots__ = ("graph", "inputs", "out", "launches", "replays")

    def __init__(self, graph, inputs, out, launches, replays=None):
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.launches = launches
        self.replays = replays  # a counter of this graph's replays, or None

    @property
    def collectives(self) -> int:
        """The collective (NCCL) calls captured into the graph: each
        replay makes them."""
        from mlops_tpu_torch.parallel.collectives import COLLECTIVE_CALLS

        return dict(self.launches).get(COLLECTIVE_CALLS, 0)

    def replay(self) -> None:
        """Launch the graph on the current stream and count the kernels
        it launches (and the replay, where the graph has a counter)."""
        self.graph.replay()
        for counter, n in self.launches:
            counter.add(n)
        if self.replays is not None:
            self.replays.add()


def capture(
    run: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    lead: tuple[int, ...],
    device: torch.device,
    stream: torch.cuda.Stream,
    pool,
    replays=None,
) -> tuple[ServingGraph, float, int]:
    """Capture ``run(cat_ids, numeric, mask) -> packed output`` over a new
    static input buffer of ``lead`` rows on ``stream`` into ``pool``.

    The caller holds the engine lock and has already run ``run``'s
    program once eagerly on ``stream`` (the kernel library's build and
    load, cuBLAS's handle and workspace for this stream, the allocator's
    first blocks: work a capture cannot do). ``stream`` is the engine's
    capture stream, never the one dispatches run on: other threads free
    pinned buffers that dispatches used, and a free records an event on
    the stream that used it, which a capturing stream must not receive.
    Capture errors are thread-local, so other threads may allocate or
    wait meanwhile. This is ``torch.cuda.graph`` without its entry's
    device synchronize and cache emptying: emptying the pinned-memory
    cache races those other threads. Returns the graph, the capture's
    seconds and the bytes the pool grew by; raises whatever the capture
    raised. ``replays``, a ``LaunchCounter``, counts each replay of the
    graph (the gbm tier's, which launches no hand-written kernel)."""
    before = [(c, c.captured) for c in LAUNCH_COUNTERS]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.stream(stream):
        inputs = torch.zeros(input_nbytes(lead), dtype=torch.uint8, device=device)
        views = split_inputs(inputs, lead)
        reserved = torch.cuda.memory_reserved(device)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = run(*views)
        finally:
            graph.capture_end()
    grown = torch.cuda.memory_reserved(device) - reserved
    seconds = time.perf_counter() - t0
    launches = tuple(
        (c, c.captured - n) for c, n in before if c.captured != n
    )
    return ServingGraph(graph, inputs, out, launches, replays), seconds, grown
