"""PyTorch/CUDA port of the credit-default serving path.

A package of its own beside the JAX reference (``mlops_tpu``): it imports
``torch`` and numpy, never ``jax`` and nothing of ``mlops_tpu``, and
keeps its own copies of the jax-free modules it needs. Its entry points
run on the CUDA card unless the caller passes ``device="cpu"``
(``serve.device=cpu`` on the CLI); without a card and without that
request they raise instead of carrying on quietly on the CPU.

This slice serves ``POST /predict`` on the quantized-student tier: the
bundle loader (``bundle``), the engine (``serve.engine``), the fused
quant-predict CUDA kernel (``ops.quant_kernel`` + ``csrc/quant_fused.cu``)
and a small asyncio HTTP server (``serve.server``).
"""

__version__ = "0.1.0"
