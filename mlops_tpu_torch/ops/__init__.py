"""Numeric ops of the serving path: drift, outliers, the quant student
and its fused CUDA kernel."""
