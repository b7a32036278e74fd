"""Plain-torch oracles for the multi-rank kernels (the port's own copy of
``repro.kernels.ref``): the allclose targets of ``chip_smoke.py`` and
the tests."""
from __future__ import annotations

import torch

NEG = torch.finfo(torch.float32).min


def ag_gemm_ref(a_shards, b_full):
    """a_shards: (W, M, K/W) the per-rank shards; b_full: (K, N). The
    fused AG+GEMM's per-rank output, in the shards' dtype."""
    a_full = torch.cat(list(a_shards), dim=-1)
    return (a_full.float() @ b_full.float()).to(a_shards[0].dtype)


def flash_decode_ref(q, k, v, cur_len, scale, window=None):
    """Dense-softmax oracle over the first cur_len positions.
    q: (B, H, D); k, v: (B, S, KVH, D) in GLOBAL position order; cur_len
    a scalar or (B,)."""
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < cl
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    valid = valid.expand(B, S)
    qg = q.float().reshape(B, KVH, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def strided(x, W):
    """Global position order -> the strided layout (B, S, ...) whose
    rank-r shard ``[:, r*S/W:(r+1)*S/W]`` holds positions j*W + r."""
    B, S = x.shape[:2]
    return (x.reshape(B, S // W, W, *x.shape[2:]).transpose(1, 2)
            .reshape(x.shape))
