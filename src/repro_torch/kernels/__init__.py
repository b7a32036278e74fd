"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it: ``matmul`` (tiled GEMM) and ``flash_decode``
(paged GQA flash decode). Sources live in ``repro_torch/csrc``."""
