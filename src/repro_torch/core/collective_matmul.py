"""All-gather + GEMM with A sharded on K (port of the paper's Figure-3
site in ``repro.core.collective_matmul``): A (M, K/W) per rank, B (K, N)
replicated, C = sum_s A_s @ B_s on every rank. Used for the decode
row-parallel projection (``wo``).

Modes, as in the JAX package (``fused`` lives in ``kernels.ag_gemm``):

* ``bsp``        gather A fully on every rank, then one GEMM;
* ``ring``       W steps: multiply the shard held, pass it to the right
                 neighbour;
* ``ring_bidir`` two half-shards travel the ring in opposite directions.

Per-rank GEMMs go through the GEMM kernel (``kernels.matmul``; its plain
version for CPU tensors); rank-to-rank moves are copies onto the
receiving rank's device. ``ag_gemm_m_sharded`` and ``gemm_rs`` belong
to the prefill/train sites and are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul


def _mm(a, b):
    """(..., k) @ (k, N) through the GEMM kernel."""
    lead = a.shape[:-1]
    return matmul(a.reshape(-1, a.shape[-1]).contiguous(), b).reshape(
        *lead, b.shape[1])


def ag_gemm_k_sharded(a_shards, b, *, mode: str = "ring"):
    """C = concat_K(A) @ B with A K-sharded. a_shards: per rank
    (..., M, K/W); b: per rank (K, N). Returns per rank (..., M, N)."""
    W = len(a_shards)
    k = a_shards[0].shape[-1]
    devs = [x.device for x in a_shards]

    def move(x, r):
        return x.to(devs[r], copy=x.device != devs[r])

    if mode == "bsp":
        out = []
        for r in range(W):
            a_full = torch.empty((*a_shards[r].shape[:-1], W * k),
                                 dtype=a_shards[r].dtype, device=devs[r])
            for s in range(W):
                a_full[..., s * k:(s + 1) * k].copy_(a_shards[s])
            out.append(_mm(a_full, b[r]))
        return out

    if mode == "ring":
        cur, acc = list(a_shards), [None] * W
        for t in range(W):
            for r in range(W):
                s = (r - t) % W          # shard held by rank r at step t
                part = _mm(cur[r], b[r][s * k:(s + 1) * k])
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur = [move(cur[(r - 1) % W], r) for r in range(W)]
        return acc

    if mode == "ring_bidir":
        h = k // 2
        cur_r = [a[..., :h].contiguous() for a in a_shards]
        cur_l = [a[..., h:].contiguous() for a in a_shards]
        acc = [None] * W
        for t in range(W):
            for r in range(W):
                s_r, s_l = (r - t) % W, (r + t) % W
                part = (_mm(cur_r[r], b[r][s_r * k:s_r * k + h])
                        + _mm(cur_l[r], b[r][s_l * k + h:(s_l + 1) * k]))
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur_r = [move(cur_r[(r - 1) % W], r) for r in range(W)]
                cur_l = [move(cur_l[(r + 1) % W], r) for r in range(W)]
        return acc

    raise ValueError(f"unknown mode {mode!r}")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"collective_matmul: {msg}")


def ag_gemm_k_sharded_sm(a, b, mesh, *, axis="model", mode="ring"):
    """a: (..., M, K) with K sharded over the mesh's ranks -- one tensor
    per rank (each rank keeps its own K/W columns, as ``shard_map`` does
    with a replicated input) or one tensor for every rank; b: (K, N), one
    per rank or one for all. Returns per rank (..., M, N)."""
    W = mesh.size
    a_r = a if isinstance(a, (list, tuple)) else [a] * W
    b_r = b if isinstance(b, (list, tuple)) else [b] * W
    K = a_r[0].shape[-1]
    _check(K % W == 0,
           f"ag_gemm_k_sharded: K={K} must divide by the '{axis}' axis "
           f"size W={W} (A is K-sharded; a ragged shard would silently "
           f"drop columns)")
    _check(b_r[0].shape[0] == K,
           f"ag_gemm_k_sharded: A K dim {K} != B K dim {b_r[0].shape[0]}")
    _check(mode != "ring_bidir" or (K // W) % 2 == 0,
           f"ag_gemm_k_sharded: ring_bidir splits the local K shard "
           f"K/W={K // W} in half; it must be even — odd shards "
           f"mis-slice B's row blocks and return silently WRONG results "
           f"(measured max err ~5 on a unit test, not a rounding issue)")
    k = K // W
    shards = [a_r[r][..., r * k:(r + 1) * k].to(mesh.devices[r])
              for r in range(W)]
    return ag_gemm_k_sharded(shards, [x.to(mesh.devices[r]) for r, x in
                                      enumerate(b_r)], mode=mode)
