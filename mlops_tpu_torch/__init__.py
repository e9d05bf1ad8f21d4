"""PyTorch/CUDA port of the credit-default serving path.

A package of its own beside the JAX reference (``mlops_tpu``): it imports
``torch`` and numpy, never ``jax`` and nothing of ``mlops_tpu``, and
keeps its own copies of the jax-free modules it needs. Its entry points
run on the CUDA card unless the caller passes ``device="cpu"``
(``serve.device=cpu`` or ``train.device=cpu`` on the CLI); without a card
and without that request they raise instead of carrying on quietly on
the CPU.

Ported so far: ``POST /predict`` on the quantized-student tier (the
bundle loader, the engine, the fused quant-predict CUDA kernel and a
small asyncio HTTP server), ``predict-file`` on long-context ``doc``
bundles (the document BERT with the flash-attention forward CUDA
kernel), and ``train`` of that model (the two flash-attention backward
CUDA kernels behind an autograd Function, AdamW, checkpoints, the
bundle and the registry).
"""

__version__ = "0.1.0"
