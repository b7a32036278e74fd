"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX or ``repro``. It serves and trains the dense
``attn_mlp`` models (llama3-8b at full width), the MoE ``attn_moe``
ones (olmoe-1b-7b, mixtral-8x22b) and the recurrent families, the zamba2
hybrid ``mamba_hybrid`` (zamba2-1.2b) and ``rwkv`` (rwkv6-3b), through
the continuous-batching paged-KV engine and the trainer (every family
at one rank or over W ranks), and the vlm and audio frontends
(paligemma-3b, hubert-xlarge), with the projections, the experts'
batched products and the paged attention on hand-written CUDA kernels
(``repro_torch/csrc``).
"""
