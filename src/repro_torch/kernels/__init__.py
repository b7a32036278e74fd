"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it: ``matmul`` (tiled GEMM), ``flash_decode`` (paged and
strided GQA flash decode, one rank or fused over W ranks) and
``ag_gemm`` (fused all-gather + GEMM). Sources live in
``repro_torch/csrc``; ``symm`` holds the multi-rank kernels' symmetric
buffers."""
