"""Warm start: build the kernel libraries a deployment serves with into
``cache.dir`` ahead of time.

The port's counterpart of the JAX package's ``compilecache/`` and its
``warmup`` command. There the artifacts are serialized XLA executables,
which have no counterpart on a CUDA card; here they are the package's
kernel libraries (``ops/cuda_build.py``), named by the hash of their
source, headers and flags, each with the sha256 of its bytes beside it.
``warmup --cache-dir D`` builds the libraries the resolved bundle's
serving programs need into ``D/kernels/`` and prints one JSON report; a
process started with ``cache.dir=D`` (``MLOPS_TPU_CACHE_DIR``) then loads
them from there and calls nvcc zero times, which is what makes the ring
plane's engine respawn quick. Building needs nvcc but no card, so an
image can bake the cache at build time.

CUDA graphs cannot be persisted: each engine process captures its
serving graphs at warmup (a fraction of a second for the 16 to 32
programs a bundle serves), after its kernels are loaded. The gbm tier
builds no library; the report names its serving programs
(``gbm_serve_entries``), as the JAX warmup enumerates them.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any

from mlops_tpu_torch.ops import cuda_build


def libraries() -> dict[str, cuda_build.KernelLibrary]:
    """Every kernel library of the package by name: the ones the kernel
    modules load (importing them imports torch, so this is a call)."""
    from mlops_tpu_torch.ops import attention, quant_kernel  # noqa: F401  (they register)

    return {lib.name: lib for lib in cuda_build.KERNEL_LIBRARIES}


def bundle_libraries(bundle, serve_tier: str, tier_routing: bool) -> list[str]:
    """The libraries ``bundle``'s serving programs launch: the doc
    model's flash forward (``predict-file``), the fused quant kernel
    where the engine's tier table serves the gated quant tier (as the
    default, ``auto``, or beside the exact tier with routing), none for
    the exact tier alone (plain PyTorch)."""
    if bundle.flavor == "doc":
        return ["flash_attention"]
    gated = bundle.has_quant and bundle.quant_gates_passed
    return ["quant_fused"] if gated and (serve_tier != "exact" or tier_routing) else []


def gbm_serve_entries(bundle, buckets: tuple[int, ...],
                      grouping: bool = True) -> list[str] | None:
    """The gbm tier's serving programs a deployment of ``bundle`` runs,
    labelled as the JAX package's ``serve_gbm_jobs`` and
    ``serve_gbm_group_jobs`` label their cache entries (one per warmup
    bucket, and per group geometry when the micro-batcher groups), or
    None when it never dispatches them (no bundle, another flavor, or an
    rf ensemble, which keeps the host hybrid). As there, they exist only
    for a fitted ensemble: the traversal's depth is a fact of the trees.
    No kernel library serves them (the tier is plain PyTorch): each engine
    captures them into CUDA graphs at its own warmup."""
    from mlops_tpu_torch.serve.wire import GROUP_ROW_BUCKETS, GROUP_SLOT_BUCKETS

    if bundle is None or bundle.flavor != "sklearn" or bundle.gbm_tensor is None:
        return None
    entries = [f"serve-predict-gbm-packed/b{b}" for b in buckets]
    if grouping:
        entries += [f"serve-predict-gbm-group-packed/g{s}x{r}"
                    for r in GROUP_ROW_BUCKETS for s in GROUP_SLOT_BUCKETS]
    return entries


def warm_kernels(names: list[str], workers: int = 0) -> dict[str, Any]:
    """Build (or reuse) ``names`` into the kernel directory, ``workers``
    nvcc processes at a time (0: one after another); one report row per
    library."""
    t0 = time.perf_counter()
    calls = cuda_build.nvcc_calls()

    by_name = libraries()

    def build(name: str) -> dict[str, Any]:
        result = by_name[name].build()
        return {"name": name, "path": str(result.path), "reused": result.reused,
                "nvcc_s": round(result.seconds, 3)}

    if workers > 0 and len(names) > 1:
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            rows = list(pool.map(build, names))
    else:
        rows = [build(name) for name in names]
    return {
        "cache_dir": str(cuda_build.kernel_dir()),
        "libraries": rows,
        "built": sum(not row["reused"] for row in rows),
        "reused": sum(row["reused"] for row in rows),
        "nvcc_calls": cuda_build.nvcc_calls() - calls,
        "warmup_s": round(time.perf_counter() - t0, 3),
    }
