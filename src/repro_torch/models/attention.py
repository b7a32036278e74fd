"""GQA attention, decode step (port of the decode half of
``repro.models.attention``): the paged pool and the contiguous strided
cache, on one rank or over the W ranks of the ambient mesh.

Values in the decode step: ``params``, ``x``, ``cur_len``, ``active``
and ``block_tables`` are lists with one entry per distinct device of the
mesh (one entry at W = 1); the caches are lists of per-rank shards
(``distributed.context``)."""
from __future__ import annotations

import torch

from repro_torch.core import flash_decode as fd
from repro_torch.core import patterns
from repro_torch.distributed import context as dctx
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models.layers import apply_rope, dense, dense_group
from repro_torch.models.module import Param


def attn_spec(cfg):
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": Param((d, H * hd), init="scaled", axes=("embed", "heads")),
        "wk": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wv": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wo": Param((H * hd, d), init="scaled", axes=("heads", "embed")),
    }


def _qkv(params, x, cur_len, cfg):
    """q (B, H, hd), k/v (B, KVH, hd) of this step, RoPE at cur_len - 1;
    the three projections are one grouped GEMM call."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = dense_group(x, [params["wq"], params["wk"], params["wv"]])
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, KVH, hd)
    v = v.reshape(B, 1, KVH, hd)
    pos = (cur_len - 1).reshape(-1, 1)
    if cfg.rope_theta:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q[:, 0].contiguous(), k[:, 0], v[:, 0]


def decode_attn_step(params, x, cache, cur_len, cfg, active,
                     block_tables=None, bounded: bool = True):
    """One-token decode. x: per device (B, 1, d); cache: dict(k, v) of
    per-rank shards -- paged pools (n_loc, block_size, KVH, hd) with
    ``block_tables`` (per device (B, C) int32, possibly a leading
    gather-width slice), else strided caches (B, S_max / W, KVH, hd);
    cur_len: per device (B,) int32 lengths INCLUDING this step's token
    for active slots; active: per device (B,) bool.

    The K/V write goes into the cache IN PLACE (inactive slots' entries
    stay byte-identical). Attention and ``wo`` run through the fusion
    mode's patterns at W > 1 (``core.patterns``); at W = 1 through the
    paged or strided flash-decode kernel and the GEMM. ``bounded``
    (W > 1, paged) picks the table walk over the masked whole-shard
    oracle. Returns per device out (B, 1, d)."""
    ctx = dctx.current()
    mesh = ctx.mesh
    W = len(cache["k"])
    B = x[0].shape[0]
    H, hd = cfg.n_heads, cfg.hd
    scale = 1.0 / (hd ** 0.5)
    qkv = [_qkv(p, xd, cl, cfg) for p, xd, cl in zip(params, x, cur_len)]
    if W == 1:
        (q, k, v), = qkv
        if block_tables is not None:
            fd.paged_write(cache["k"][0], k, block_tables[0], cur_len[0],
                           active[0])
            fd.paged_write(cache["v"][0], v, block_tables[0], cur_len[0],
                           active[0])
            o = flash_decode_paged(q, cache["k"][0], cache["v"][0],
                                   cur_len[0], block_tables[0], scale,
                                   window=cfg.sliding_window)
        else:
            o = _strided(cfg, [q], [k], [v], cache, cur_len, active,
                         scale)[0]
        return [dense(o.reshape(B, 1, H * hd), params[0]["wo"])]

    def per_rank(i):
        return mesh.per_rank([t[i] for t in qkv])
    q, k, v = per_rank(0), per_rank(1), per_rank(2)
    cl, act = mesh.per_rank(cur_len), mesh.per_rank(active)
    if block_tables is not None:
        o, _, _ = patterns.decode_attn_paged(
            q, k, v, cache["k"], cache["v"], cl,
            mesh.per_rank(block_tables), scale=scale,
            window=cfg.sliding_window, active=act, bounded=bounded)
    else:
        o = _strided(cfg, q, k, v, cache, cl, act, scale)
    out = patterns.project_k_sharded(
        [t.reshape(B, 1, H * hd) for t in o],
        mesh.per_rank([p["wo"] for p in params]))
    return mesh.from_ranks(out)


def _strided(cfg, q, k, v, cache, cur_len, active, scale):
    """Contiguous strided cache: ownership write + attention (at W = 1
    the contiguous flash-decode kernel's single-source path). A window
    at least as long as the cache makes it a rolling ring (positions
    wrap modulo S_max, the cache holds the last S_max tokens)."""
    W = len(cache["k"])
    S_max = cache["k"][0].shape[1] * W
    rolling = (cfg.sliding_window is not None
               and S_max <= cfg.sliding_window)
    o, _, _ = patterns.decode_attn_fused(
        q, k, v, cache["k"], cache["v"], cur_len, scale=scale,
        window=None if rolling else cfg.sliding_window,
        rolling_len=S_max if rolling else None, active=active)
    return o


def init_paged_cache(cfg, n_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Paged KV pool: blocks are shared across slots and indexed through
    per-slot block tables."""
    KVH, hd = cfg.n_kv_heads, cfg.hd
    shape = (n_blocks, block_size, KVH, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu", W: int = 1):
    """One rank's shard (batch, S_max / W, KVH, hd) of a contiguous cache
    in the strided layout. For sliding-window configs S_max is bounded
    by the window (a rolling cache)."""
    KVH, hd = cfg.n_kv_heads, cfg.hd
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    if max_len % W:
        raise ValueError(f"cache length {max_len} must divide by the "
                         f"{W} ranks of the strided layout")
    shape = (batch, max_len // W, KVH, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
