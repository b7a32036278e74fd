"""Paged KV write and dense decode-attention references (port of the
single-device half of ``repro.core.flash_decode``).

Layout contract (shared with ``serving.kv_cache``): the KV pool is
``(n_blocks, block_size, KVH, D)``; logical position ``p`` of slot ``b``
lives at pool block ``tables[b, p // block_size]``, offset
``p % block_size``; ``-1`` is an unallocated entry or a reclaim hole.

Unlike JAX, :func:`paged_write` updates the pool IN PLACE.
"""
from __future__ import annotations

import torch

NEG = torch.finfo(torch.float32).min


def gather_paged_view(pool, tables):
    """Logical per-slot view of a paged pool: (B, C*bs, KVH, D) in
    position order. ``-1`` entries gather a clamped garbage block —
    callers mask by ``cur_len``."""
    t = tables.long().clamp(0, pool.shape[0] - 1)
    v = pool[t]                                   # (B, C, bs, KVH, D)
    B, C, bs = v.shape[:3]
    return v.reshape(B, C * bs, *pool.shape[2:])


def paged_write(pool, new, tables, cur_len, active):
    """Write each active slot's new KV at position ``cur_len - 1``
    through its table row, IN PLACE. pool: (n_blocks, bs, KVH, D);
    new: (B, KVH, D); tables: (B, C) (may be a leading column slice);
    cur_len: (B,); active: (B,) bool. Writes of inactive slots, of
    ``-1`` entries and of positions past the table slice are dropped.

    The drop needs no host sync: every dropped row is redirected to the
    target of the first kept row and carries that row's value, so
    duplicate targets all store the same bytes; with no kept row at all,
    every row rewrites one location with its current value. Kept rows
    have distinct targets (each slot writes a private block). Returns
    ``pool``."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    C = tables.shape[1]
    pos = (cur_len.long() - 1).clamp_min(0)
    chunk = pos // bs
    blk = tables.gather(1, chunk.clamp_max(C - 1)[:, None])[:, 0].long()
    ok = active & (blk >= 0) & (chunk < C)
    flat = blk.clamp_min(0) * bs + pos % bs           # (B,) pool rows
    rows = pool.view(n_blocks * bs, *pool.shape[2:])
    first = torch.argmax(ok.to(torch.int32))          # first kept row (or 0)
    tgt = torch.where(ok, flat, flat[first])
    val = torch.where(ok[:, None, None], new.to(pool.dtype), new[first]
                      .to(pool.dtype)[None])
    val = torch.where(ok.any(), val, rows[tgt])
    rows[tgt] = val
    return pool


def reference_paged_decode_attention(q, k_pool, v_pool, cur_len, tables,
                                     scale, window: int | None = None):
    """Single-device paged oracle: gather the logical view, then dense
    attention."""
    kview = gather_paged_view(k_pool, tables)
    vview = gather_paged_view(v_pool, tables)
    return reference_decode_attention(q, kview, vview, cur_len, scale,
                                      window=window)


def reference_decode_attention(q, k, v, cur_len, scale,
                               window: int | None = None):
    """Oracle: dense fp32 softmax attention over the first cur_len
    positions. q: (B, H, D); k/v: (B, S, KVH, D); cur_len: (B,) or a
    scalar."""
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cur_len, device=q.device)
    cl = cl.reshape(-1, 1) if cl.dim() else cl
    valid = pos[None, :] < cl
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    valid = valid.expand(B, S)
    qg = q.float().reshape(B, KVH, g, D)
    kT = k.float().transpose(1, 2)                   # (B, KVH, S, D)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kT) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    vT = v.float().transpose(1, 2)
    o = torch.einsum("bkgs,bksd->bkgd", p, vT)
    return o.reshape(B, H, D).to(q.dtype)
