"""Bundle directories (quant tier)."""

from mlops_tpu_torch.bundle.bundle import Bundle, load_bundle, save_quant_bundle

__all__ = ["Bundle", "load_bundle", "save_quant_bundle"]
