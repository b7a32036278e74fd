"""GEMM: ``C = A @ B`` with an fp32 accumulator (port of the Pallas
``repro.kernels.matmul.matmul``).

:func:`matmul` is what the model calls for every decode projection
(q/k/v/o, the MLP, the unembed). For CUDA tensors it launches the
hand-written kernel in ``csrc/matmul.cu``; for CPU tensors it runs
:func:`matmul_plain`. There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Counters: ``matmul.launches`` counts kernel launches and
``matmul.plain_calls`` counts plain-version calls, so a run can show
which one its main path went through.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 trans_b: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 product, output in
    ``a``'s dtype. ``b`` is (K, N), or (N, K) with ``trans_b``."""
    bf = b.float().T if trans_b else b.float()
    return (a.float() @ bf).to(a.dtype)


def _lib():
    lib = _build.load("matmul")
    fn = lib.mm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           trans_b: bool = False) -> torch.Tensor:
    """``a`` (M, K) @ ``b`` (K, N) -> (M, N) in ``a``'s dtype; with
    ``trans_b``, ``b`` is given as (N, K) and read transposed. Any M, N,
    K; f32 x f32 or bf16 x bf16."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)}"
                         f" @ {tuple(b.shape)}")
    M, K = a.shape
    N, Kb = (b.shape if trans_b else (b.shape[1], b.shape[0]))
    if Kb != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    if a.device.type == "cpu" and b.device.type == "cpu":
        matmul.plain_calls += 1
        return matmul_plain(a, b, trans_b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"matmul operands on {a.device} and {b.device}: "
                         f"both must be CPU tensors or on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes f32 x f32 or bf16 x bf16, "
                        f"got {a.dtype} x {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel needs contiguous row-major operands")
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                int(trans_b), _DTYPES[a.dtype], stream)
    _build.check(rc, "matmul")
    matmul.launches += 1
    return c


matmul.launches = 0
matmul.plain_calls = 0
