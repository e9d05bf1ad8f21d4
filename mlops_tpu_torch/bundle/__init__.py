"""Bundle directories (the exact and quant tiers of the flax flavor, the
doc flavor and the sklearn flavor).

The loaders import torch, so they load on first use: the ring plane's
supervisor and front ends resolve a bundle through ``bundle.registry``
without torch in the process."""

__all__ = [
    "Bundle",
    "load_bundle",
    "save_doc_bundle",
    "save_exact_bundle",
    "save_quant_bundle",
    "save_sklearn_bundle",
]


def __getattr__(name: str):
    if name in __all__:
        from mlops_tpu_torch.bundle import bundle

        return getattr(bundle, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
