"""Warm start: the package's kernel libraries built ahead of serving
(``warmup --cache-dir``; see ``warmup.py``)."""

from mlops_tpu_torch.compilecache.warmup import (
    bundle_libraries,
    gbm_serve_entries,
    libraries,
    warm_kernels,
)

__all__ = ["bundle_libraries", "gbm_serve_entries", "libraries", "warm_kernels"]
