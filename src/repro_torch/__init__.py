"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX or ``repro``. Its first slice serves dense ``attn_mlp``
models (llama3-8b at full width) through the continuous-batching
paged-KV engine, with the decode projections and the paged attention on
hand-written CUDA kernels (``repro_torch/csrc``).
"""
