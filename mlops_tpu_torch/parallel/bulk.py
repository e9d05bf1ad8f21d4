"""Bulk scoring: stream an encoded dataset through one chunk program
(classifier probabilities and outlier flags), then compute dataset-level
drift on a bounded row sample.

Port of the JAX package's ``parallel/bulk.py``. On a data mesh (``mesh``:
the world's ranks, one card each) a chunk's rows round up to the 'data'
axis (``mesh_chunk_rows``), each rank slices, copies to its card and
scores only its block of every chunk (``sharding.row_block``) with the
whole (replicated) params, and the blocks are gathered over the axis, so
every rank holds every result (the coordinator writes the output). An
``sklearn`` bundle scores on each rank's host whole. A sweep
runs on the staged executor
(``data/pipeline_exec.py``): slice and pad a chunk on the host, copy it
to the device, compute, fetch the results in waves, store. On the card:

- **transfer** writes the chunk into one of a ring of pinned staging
  buffers (f32 numerics ‖ int8 categoricals ‖ bool mask; the ids widen
  on the device), and copies it to the device on a copy stream behind an
  event. A staging buffer is written again only after its copy's event
  completed.
- **compute** runs every chunk on one fixed compute stream, which waits
  on the chunk's copy event; the copied buffer is marked as used by that
  stream (``record_stream``), so the caching allocator cannot hand its
  memory out under the live work. One stream for every chunk keeps the
  same kernels and library algorithms at any pipeline depth, so depth 1
  and depth 2 give the same bits.
- **fetch** copies up to ``FETCH_WAVE`` chunks' results into pinned host
  buffers on a second copy stream and waits for that wave's event; no
  device-wide synchronize runs in the sweep.

Depth 1 runs the same stages serially on the caller's thread. On the
CPU (``device="cpu"``) the same stages run on host tensors.

Paths: ``exact`` (the serving-identical model), ``distilled`` (the bundle's
bulk student, ``train/distill.py``) and ``quant`` (the int8/bf16 student,
its composite forward: the JAX bulk body does not call the fused serving
kernel either). An ``sklearn`` bundle (gbm or rf) scores as the JAX
package scores it: the estimator on the host (``SklearnChunkScorer``),
the outlier flags on the device, the slice, transfer and fetch stages on
host arrays with the original int32 ids. Predictions are ``sigmoid(logit
/ T)`` with the tier's temperature (the estimator's tempered
probabilities); flags are exact per row; drift is a dataset-level
statistic on a uniform sample of ``drift_sample`` rows, the serving
monitor's semantics at bounded cost.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from mlops_tpu_torch.bundle.bundle import Bundle
from mlops_tpu_torch.data.encode import EncodedDataset
from mlops_tpu_torch.device import resolve_device
from mlops_tpu_torch.monitor.state import drift_scores, outlier_flags
from mlops_tpu_torch.ops.predict import model_params
from mlops_tpu_torch.ops.quant import quant_student_logits
from mlops_tpu_torch.parallel.sharding import gather_tensor, row_block
from mlops_tpu_torch.schema.features import SCHEMA

# Chunks one fetch drains at once, and how far the compute stage may run
# ahead of it.
FETCH_WAVE = 32

_C = SCHEMA.num_categorical
_M = SCHEMA.num_numeric

DOC_REFUSAL = (
    "doc bundles score record histories via "
    "`predict-file data.train_path=<history csv>`; the bulk "
    "scorer's per-record contract does not apply"
)


def mesh_chunk_rows(chunk_rows: int, mesh: Any = None) -> int:
    """The one chunk-size rule over a data mesh (the JAX package's): round
    up to the 'data' axis, at least one row per rank."""
    if mesh is None:
        return max(1, chunk_rows)
    axis = int(mesh.shape["data"])
    return max(axis, ((chunk_rows + axis - 1) // axis) * axis)


@dataclasses.dataclass
class BulkScoreResult:
    predictions: np.ndarray  # float32 [N]
    outliers: np.ndarray  # float32 [N]
    feature_drift: dict[str, float]  # per-feature 1 - p on the sample
    rows: int
    elapsed_s: float  # the sweep's wall time (excludes data making / IO)
    path: str = "exact"  # "exact" | "distilled" | "quant": which params scored
    pipeline: dict[str, Any] | None = None  # per-stage busy/occupancy

    @property
    def rows_per_s(self) -> float:
        return self.rows / max(self.elapsed_s, 1e-9)

    def summary(self) -> dict[str, Any]:
        return {
            "rows": self.rows,
            "path": self.path,
            "elapsed_s": round(self.elapsed_s, 4),
            "rows_per_s": round(self.rows_per_s, 1),
            "default_rate": (
                round(float((self.predictions >= 0.5).mean()), 6) if self.rows else 0.0
            ),
            "outlier_rate": (
                round(float(self.outliers.mean()), 6) if self.rows else 0.0
            ),
            "feature_drift_batch": {
                k: round(v, 6) for k, v in self.feature_drift.items()
            },
            **(
                {"pipeline": self.pipeline} if self.pipeline is not None else {}
            ),
        }


def use_distilled_bulk(
    bundle: Bundle, exact: bool | None = None, device: str | torch.device | None = None
) -> bool:
    """Route through the distilled student when the bundle carries one and
    either the caller asked for it (``exact=False``) or, the auto default,
    the device is the CPU. On the card the exact model is fast, so auto
    keeps it."""
    if exact is True or not bundle.has_bulk:
        return False
    if exact is False:
        return True
    return resolve_device(device).type == "cpu"


def use_quant_bulk(bundle: Bundle, tier: str = "exact") -> bool:
    """Quant-tier routing, with the serving tier's demand-vs-preference
    semantics: ``tier="quant"`` is a demand (raises when the bundle has no
    gate-passed quant tier), ``"auto"`` takes a gated quant tier when
    there is one, ``"exact"`` never routes here."""
    if tier not in ("exact", "quant", "auto"):
        raise ValueError(f"tier must be exact|quant|auto, got {tier!r}")
    if tier == "exact":
        return False
    eligible = (
        bundle.flavor != "sklearn"
        and bundle.has_quant
        and bundle.quant_gates_passed
    )
    if tier == "quant" and not eligible:
        raise ValueError(
            "tier='quant' refused: bundle carries no gate-passed quant "
            "params (train with train.distill_quant=true)"
        )
    return eligible


def bulk_path(
    bundle: Bundle,
    exact: bool | None = None,
    tier: str = "exact",
    device: str | torch.device | None = None,
) -> str:
    """Which params a sweep scores with: quant, then distilled, then exact."""
    if use_quant_bulk(bundle, tier):
        return "quant"
    if use_distilled_bulk(bundle, exact, device):
        return "distilled"
    return "exact"


def make_bulk_fused(model: torch.nn.Module) -> Callable:
    """The bulk chunk program of a model: ``(params, monitor, temperature,
    cat int8 [N, C], numeric [N, M], mask [N]) -> (probs, flags)``. The ids
    travel as int8 (the largest vocabulary is 12) and widen here."""

    def fused(params, monitor, temperature, cat, num, mask):
        logits = functional_call(model, params, (cat.int(), num))
        return torch.sigmoid(logits / temperature), outlier_flags(monitor, num, mask)

    return fused


def make_bulk_quant_fused() -> Callable:
    """The quant tier's chunk program: the int8/bf16 student's composite
    forward (dequantized, f32) in place of the model, the same contract as
    ``make_bulk_fused``."""

    def fused(qparams, monitor, temperature, cat, num, mask):
        logits = quant_student_logits(qparams, cat.int(), num)
        return torch.sigmoid(logits / temperature), outlier_flags(monitor, num, mask)

    return fused


@dataclasses.dataclass
class DeviceChunk:
    """A chunk's tensors on the device, the buffer that owns them and the
    event recorded after the work that made them (None on the CPU)."""

    tensors: tuple[torch.Tensor, ...]
    owner: torch.Tensor
    ready: torch.cuda.Event | None = None


def _layout(rows: int) -> tuple[int, int, int]:
    """Byte offsets of a packed chunk: f32 numerics [rows, M] at 0, int8
    ids [rows, C], bool mask [rows]; the total."""
    num_end = 4 * rows * _M
    cat_end = num_end + rows * _C
    return num_end, cat_end, cat_end + rows


def _split(buf, rows: int, view: Callable) -> tuple:
    num_end, cat_end, total = _layout(rows)
    return (
        view(buf[num_end:cat_end], "int8").reshape(rows, _C),
        view(buf[:num_end], "float32").reshape(rows, _M),
        view(buf[cat_end:total], "bool").reshape(rows),
    )


class ChunkTransfer:
    """The transfer stage: ``(cat int8 [R, C], num f32 [R, M], mask [R])``
    host arrays -> a ``DeviceChunk`` of ``(cat, num, mask)``. On the card
    through a ring of ``slots`` pinned staging buffers and a copy stream;
    on the CPU the arrays as tensors."""

    def __init__(self, device: torch.device, rows: int, slots: int = 3) -> None:
        self.device = device
        self.rows = rows
        self._cuda = device.type == "cuda"
        if self._cuda:
            nbytes = _layout(rows)[2]
            self.stream = torch.cuda.Stream(device)
            self._ring = [
                torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                for _ in range(max(1, slots))
            ]
            self._copied: list[torch.cuda.Event | None] = [None] * len(self._ring)
            self._next = 0

    def __call__(self, cat: np.ndarray, num: np.ndarray, mask: np.ndarray) -> DeviceChunk:
        if not self._cuda:
            tensors = tuple(map(torch.from_numpy, (cat, num, mask)))
            return DeviceChunk(tensors, tensors[1])
        slot = self._next
        self._next = (slot + 1) % len(self._ring)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the copy out of it is done
        host = self._ring[slot]
        for dst, src in zip(
            _split(host.numpy(), self.rows, lambda a, dtype: a.view(dtype)),
            (cat, num, mask),
        ):
            dst[...] = src
        with torch.cuda.stream(self.stream):
            buf = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self._copied[slot] = ready
        return DeviceChunk(
            _split(buf, self.rows, lambda t, dtype: t.view(getattr(torch, dtype))),
            buf,
            ready,
        )


class ChunkScorer:
    """The compute stage: one chunk program over the tier's params, the
    monitor and the temperature, held on the device. ``__call__`` takes a
    ``DeviceChunk`` and returns one holding ``[2, R]`` f32 (probabilities,
    flags); on the card every chunk runs on the scorer's one stream after
    its copy's event. ``score`` runs the program on tensors of the
    current stream (the reference route of the checks). On a data
    ``mesh`` the chunk it takes is this rank's block (``block``) and the
    ``[2, R]`` it returns is the whole chunk's, gathered over 'data'."""

    ids_dtype = np.int8  # the ids travel as int8 (the largest vocabulary is 12)
    warm_rows = None  # the warm-up chunk: every row valid

    def __init__(
        self, bundle: Bundle, path: str, device: torch.device, mesh: Any = None
    ) -> None:
        self.path = path
        self.mesh = mesh
        self.device = device
        self.stage_device = device  # where the transfer stage puts chunks
        if path == "quant":
            self._fused = make_bulk_quant_fused()
            params = {k: v.to(device) for k, v in bundle.quant_params.items()}
            temperature = bundle.quant_temperature  # the quant tier's own refit
        else:
            model = bundle.bulk_model if path == "distilled" else bundle.model
            if model is None:
                raise ValueError(bundle.exact_refusal or "bundle carries no exact model")
            model = model.to(device).eval()
            self._fused = make_bulk_fused(model)
            params = model_params(model)
            # The distilled student matched the teacher's logits, so the
            # teacher's temperature applies on either path.
            temperature = bundle.temperature
        self.monitor = bundle.monitor.to(device)
        self._args = (
            params,
            self.monitor,
            torch.tensor(temperature, dtype=torch.float32, device=device),
        )
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            # The params were copied on the current stream; the compute
            # stream must not read them before those copies land.
            self.stream.wait_stream(torch.cuda.current_stream(device))

    @torch.inference_mode()
    def score(self, cat, num, mask) -> tuple[torch.Tensor, torch.Tensor]:
        return self._fused(*self._args, cat, num, mask)

    def block(self, rows: int) -> slice:
        """This rank's rows of a chunk of ``rows``: all of them off a mesh."""
        return row_block(rows, self.mesh)

    def _scored(self, tensors: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """``[2, R]`` (probabilities, flags) of a chunk: of this rank's
        block, gathered over 'data' on a mesh."""
        out = torch.stack(self.score(*tensors))
        return out if self.mesh is None else gather_tensor(out, (None, "data"), self.mesh)

    def __call__(self, chunk: DeviceChunk) -> DeviceChunk:
        if self.stream is None:
            out = self._scored(chunk.tensors)
            return DeviceChunk((out,), out)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(chunk.ready)
            chunk.owner.record_stream(self.stream)
            out = self._scored(chunk.tensors)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return DeviceChunk((out,), out, ready)


class SklearnChunkScorer:
    """The compute stage of an ``sklearn`` bundle, the JAX package's
    sklearn ``score_chunk``: the fitted estimator's tempered probabilities
    for the valid rows on the host (padding 0), the outlier flags on
    ``device``. Its chunks stay on the host (``stage_device``) with int32
    ids, and its warm-up scores one row (nothing compiles)."""

    path = "exact"
    stage_device = torch.device("cpu")
    ids_dtype = np.int32
    warm_rows = 1

    @staticmethod
    def block(rows: int) -> slice:
        """Every rank scores the whole chunk."""
        return slice(0, rows)

    def __init__(self, bundle: Bundle, device: torch.device) -> None:
        from mlops_tpu_torch.bundle.bundle import ESTIMATOR_NAME

        if bundle.estimator is None:
            raise ValueError(
                f"bulk scoring of an sklearn bundle runs its {ESTIMATOR_NAME} "
                "on the host, which needs scikit-learn and joblib"
            )
        self.device = device
        self.monitor = bundle.monitor.to(device)
        self._estimator = bundle.estimator
        self._temperature = bundle.temperature

    @torch.inference_mode()
    def score(self, cat, num, mask) -> tuple[torch.Tensor, torch.Tensor]:
        from mlops_tpu_torch.train.calibrate import apply_temperature

        valid = mask.cpu().numpy()
        probs = np.zeros(valid.shape[0], np.float32)
        p = self._estimator.predict_proba(cat.cpu().numpy()[valid], num.cpu().numpy()[valid])
        probs[valid] = apply_temperature(p, self._temperature)
        flags = outlier_flags(self.monitor, num.to(self.device), mask.to(self.device))
        return torch.from_numpy(probs), flags.cpu()

    def __call__(self, chunk: DeviceChunk) -> DeviceChunk:
        out = torch.stack(self.score(*chunk.tensors))
        return DeviceChunk((out,), out)


class ChunkFetch:
    """The fetch stage: a wave of up to ``wave`` computed chunks -> one
    ``[2, R]`` f32 numpy array each. On the card each copies into its own
    pinned buffer on a copy stream after its chunk's event, and the stage
    waits once for the wave."""

    def __init__(self, device: torch.device, rows: int, wave: int = FETCH_WAVE) -> None:
        self._cuda = device.type == "cuda"
        if self._cuda:
            self.stream = torch.cuda.Stream(device)
            self._ring = [
                torch.empty((2, rows), dtype=torch.float32, pin_memory=True)
                for _ in range(wave)
            ]

    def __call__(self, chunks: list[DeviceChunk]) -> list[np.ndarray]:
        if not self._cuda:
            return [c.owner.numpy() for c in chunks]
        if len(chunks) > len(self._ring):
            raise ValueError(f"a fetch wave holds at most {len(self._ring)} chunks")
        with torch.cuda.stream(self.stream):
            for host, chunk in zip(self._ring, chunks):
                self.stream.wait_event(chunk.ready)
                chunk.owner.record_stream(self.stream)
                host.copy_(chunk.owner, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return [host.numpy().copy() for host in self._ring[: len(chunks)]]


def _refuse_flavor(bundle: Bundle) -> None:
    if bundle.flavor == "doc":
        raise ValueError(DOC_REFUSAL)


def make_chunk_scorer(
    bundle: Bundle,
    exact: bool | None = None,
    tier: str = "exact",
    device: str | torch.device | None = None,
    mesh: Any = None,
) -> ChunkScorer | SklearnChunkScorer:
    """The chunk program of the routed path (``bulk_path``) on ``device``
    (the card unless "cpu"), row-split over ``mesh``'s 'data' axis when
    given; an ``sklearn`` bundle's host scorer (whole on every rank).
    Refuses the ``doc`` flavor."""
    _refuse_flavor(bundle)
    device = resolve_device(device)
    path = bulk_path(bundle, exact, tier, device)  # a refused quant demand raises
    if bundle.flavor == "sklearn":
        return SklearnChunkScorer(bundle, device)
    return ChunkScorer(bundle, path, device, mesh)


def make_chunk_transfer(
    device: str | torch.device | None, rows: int, depth: int = 2
) -> ChunkTransfer:
    """The transfer stage for chunks of ``rows`` rows: a ring of depth + 1
    pinned staging buffers on the card."""
    return ChunkTransfer(resolve_device(device), rows, slots=max(1, depth) + 1)


def score_dataset(
    bundle: Bundle,
    ds: EncodedDataset,
    chunk_rows: int = 131_072,
    drift_sample: int = 65_536,
    seed: int = 0,
    exact: bool | None = None,
    pipeline_depth: int = 2,
    tier: str = "exact",
    device: str | torch.device | None = None,
    mesh: Any = None,
) -> BulkScoreResult:
    """Stream ``ds`` through the chunk program on ``device`` (the card
    unless "cpu"), on a data ``mesh`` each rank scoring its block of
    every chunk; aggregate the monitors.

    Stages (``data/pipeline_exec.py``): slice (and pad the tail), transfer,
    compute, fetch (batched, ``FETCH_WAVE`` chunks deep), store. Depth 1 is
    the serial loop, with the same bits. ``exact=None`` routes through the
    distilled bulk student on the CPU when the bundle carries one;
    ``exact=True`` forces the serving-identical model; ``tier`` routes the
    quant student ahead of both (``use_quant_bulk``)."""
    from mlops_tpu_torch.data.pipeline_exec import Stage, run_pipeline

    device = resolve_device(device)
    _refuse_flavor(bundle)
    bulk_path(bundle, exact, tier, device)  # a refused quant demand raises
    n = ds.n
    if n == 0:
        # As the JAX package: no drift signal in an empty dataset, no NaN
        # rates, and the result's default path.
        return BulkScoreResult(
            predictions=np.empty(0, np.float32),
            outliers=np.empty(0, np.float32),
            feature_drift=dict.fromkeys(SCHEMA.feature_names, 0.0),
            rows=0,
            elapsed_s=0.0,
        )
    scorer = make_chunk_scorer(bundle, exact, tier, device, mesh)
    chunk = mesh_chunk_rows(chunk_rows, mesh)
    block = scorer.block(chunk)  # the rows of every chunk this rank copies and scores
    rows = block.stop - block.start
    transfer = make_chunk_transfer(scorer.stage_device, rows, pipeline_depth)
    fetch = ChunkFetch(scorer.stage_device, chunk)
    ids = scorer.ids_dtype

    # One chunk through every stage before the timed sweep: the library
    # handles, the allocator's pools and the pinned rings come up here.
    zeros = (
        np.zeros((rows, _C), ids),
        np.zeros((rows, _M), np.float32),
        np.arange(rows) < (scorer.warm_rows or rows),
    )
    fetch([scorer(transfer(*zeros))])

    predictions = np.empty(n, np.float32)
    outliers = np.empty(n, np.float32)
    base_index = np.arange(rows)
    full_mask = np.ones(rows, bool)

    def slice_chunk(span):
        start, stop = span
        lo, hi = min(start + block.start, stop), min(start + block.stop, stop)
        size = hi - lo
        cat = ds.cat_ids[lo:hi].astype(ids)
        num = ds.numeric[lo:hi]
        if size < rows:
            cat = np.pad(cat, ((0, rows - size), (0, 0)))
            num = np.pad(num, ((0, rows - size), (0, 0)))
            mask = base_index < size
        else:
            mask = full_mask
        return start, stop, cat, num, mask

    def transfer_chunk(item):
        start, stop, cat, num, mask = item
        return start, stop, transfer(cat, num, mask)

    def compute_chunk(item):
        start, stop, on_device = item
        return start, stop, scorer(on_device)

    def fetch_chunks(items):
        fetched = fetch([out for _, _, out in items])
        return [(start, stop, host) for (start, stop, _), host in zip(items, fetched)]

    def store_chunk(item):
        start, stop, host = item
        predictions[start:stop] = host[0, : stop - start]
        outliers[start:stop] = host[1, : stop - start]

    spans = ((start, min(start + chunk, n)) for start in range(0, n, chunk))
    pipe = run_pipeline(
        spans,
        [
            Stage("slice", slice_chunk),
            Stage("transfer", transfer_chunk),
            Stage("compute", compute_chunk),
            # The deep input queue lets compute run up to FETCH_WAVE chunks
            # ahead, and one wait drains them. batch_max >= 2 keeps the
            # stage list-in/list-out at depth 1 too.
            Stage("fetch", fetch_chunks, batch_max=FETCH_WAVE, queue_depth=FETCH_WAVE),
        ],
        store_chunk,
        depth=pipeline_depth,
        source_name="span",
        sink_name="store",
    )

    # Dataset-level drift on a bounded uniform sample.
    take = min(n, drift_sample)
    idx = (
        np.random.default_rng(seed).choice(n, take, replace=False)
        if take < n
        else np.arange(n)
    )
    drift = drift_scores(
        scorer.monitor,
        torch.from_numpy(ds.cat_ids[idx]).to(device),
        torch.from_numpy(ds.numeric[idx]).to(device),
        torch.ones(take, dtype=torch.bool, device=device),
    )
    return BulkScoreResult(
        predictions=predictions,
        outliers=outliers,
        feature_drift=dict(
            zip(SCHEMA.feature_names, drift.double().cpu().numpy().tolist())
        ),
        rows=n,
        elapsed_s=pipe.wall_s,
        path=scorer.path,
        pipeline=pipe.as_dict(),
    )
