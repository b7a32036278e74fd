"""Fused all-gather + GEMM (port of the Pallas
``repro.kernels.ag_gemm.ag_gemm_fused``, the paper's §4.1 push model).

:func:`ag_gemm_fused` computes ``C = concat_K(A_0, ..., A_{W-1}) @ B`` on
every rank of a mesh, where rank r holds the K shard ``A_r`` (M, K/W)
and a replica of ``B`` (K, N). For CUDA tensors it launches the
hand-written kernel in ``csrc/ag_gemm.cu`` (each rank pushes its shard
into every other rank's inbox and multiplies the sources as their flags
arrive); for CPU tensors it runs :func:`ag_gemm_plain`. At W = 1 it is
the GEMM kernel (``kernels.matmul``), as the JAX package's
``ops.ag_gemm`` routes it. A CUDA call the kernel cannot take raises.

Counters: ``ag_gemm_fused.launches`` (one per device per call) and
``ag_gemm_fused.plain_calls``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, symm
from repro_torch.kernels.matmul import matmul, matmul_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PUSHERS = 4                     # csrc/ag_gemm.cu PUSHERS


def ag_gemm_plain(a_shards, b):
    """The kernel's function in plain PyTorch: every rank "pushes" its
    shard by a copy into every rank's inbox, and each rank multiplies its
    gathered inbox by its B (fp32 product, output in A's dtype)."""
    out = []
    for br in b:
        inbox = [a.to(br.device, copy=True) for a in a_shards]
        out.append(matmul_plain(torch.cat(inbox, dim=-1), br))
    return out


def _lib():
    fn = _build.load("ag_gemm").ag_gemm_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr, ptr, i32, i32,
                                                ctypes.c_uint,
                                                ctypes.c_longlong,
                                                ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    return fn


def ag_gemm_fused(a_shards, b, mesh=None):
    """``a_shards``: per rank (M, k); ``b``: per rank (W * k, N) (ranks on
    one device may pass the same tensor). Returns per rank (M, N) in A's
    dtype; each rank sums the sources from its own shard on, so the
    ranks agree to fp32 rounding, not bit for bit. ``mesh`` (the ranks'
    devices and their symmetric buffers) is needed for CUDA tensors at
    W > 1."""
    W = len(a_shards)
    if W == 0 or len(b) != W:
        raise ValueError(f"ag_gemm_fused: {len(a_shards)} A shards and "
                         f"{len(b)} B replicas")
    M, k = a_shards[0].shape
    K, N = b[0].shape
    for r in range(W):
        if a_shards[r].dim() != 2 or a_shards[r].shape != (M, k) \
                or b[r].shape != (K, N):
            raise ValueError(f"ag_gemm_fused: rank {r} shapes "
                             f"{tuple(a_shards[r].shape)} @ "
                             f"{tuple(b[r].shape)} differ from rank 0's")
    if K != W * k:
        raise ValueError(f"ag_gemm_fused: B rows K={K} must be W={W} times "
                         f"the local A shard width k={k}")
    if W == 1:
        return [matmul(a_shards[0], b[0])]
    if all(t.device.type == "cpu" for t in (*a_shards, *b)):
        ag_gemm_fused.plain_calls += 1
        return ag_gemm_plain(a_shards, b)
    dtype = a_shards[0].dtype
    for r in range(W):
        a, br = a_shards[r], b[r]
        if a.device.type != "cuda" or br.device != a.device \
                or (mesh is not None and mesh.devices[r] != a.device):
            raise ValueError(f"ag_gemm_fused: rank {r}'s operands must be "
                             f"on its CUDA device (A on {a.device}, B on "
                             f"{br.device})")
        if a.dtype != dtype or br.dtype != dtype or dtype not in _DTYPES:
            raise TypeError(f"ag_gemm_fused: kernel takes f32 x f32 or "
                            f"bf16 x bf16 on every rank, got {a.dtype} x "
                            f"{br.dtype}")
        if not (a.is_contiguous() and br.is_contiguous()):
            raise ValueError("ag_gemm_fused: operands must be contiguous "
                             "row-major")
    if W > 32:
        raise ValueError(f"ag_gemm_fused: at most 32 ranks, got {W}")
    outs: list = [None] * W
    if M == 0 or N == 0:
        return [torch.empty((M, N), dtype=dtype, device=a.device)
                for a in a_shards]
    groups = symm.rank_groups(a_shards)
    if max(len(r) for r in groups.values()) > 8:
        raise ValueError("ag_gemm_fused: at most 8 ranks per device")
    call = symm.communicator(mesh).call(
        M * k * a_shards[0].element_size(), _PUSHERS)
    fn = _lib()
    for dev, ranks in groups.items():
        c = [torch.empty((M, N), dtype=dtype, device=dev) for _ in ranks]
        with torch.cuda.device(dev):
            rc = fn(symm.ptrs([a_shards[r] for r in ranks]),
                    symm.ptrs([b[r] for r in ranks]), symm.ptrs(c),
                    symm.ints(ranks), len(ranks), M, N, k, _DTYPES[dtype],
                    *call.args(mesh.distinct.index(dev)),
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "ag_gemm_fused")
        for r, t in zip(ranks, c):
            outs[r] = t
    ag_gemm_fused.launches += len(groups)
    return outs


ag_gemm_fused.launches = 0
ag_gemm_fused.plain_calls = 0
