"""GQA attention, paged single-device decode step (port of the paged
W = 1 branch of ``repro.models.attention``)."""
from __future__ import annotations

import torch

from repro_torch.core.flash_decode import paged_write
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models.layers import apply_rope, dense
from repro_torch.models.module import Param


def attn_spec(cfg):
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": Param((d, H * hd), init="scaled", axes=("embed", "heads")),
        "wk": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wv": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wo": Param((H * hd, d), init="scaled", axes=("heads", "embed")),
    }


def decode_attn_step(params, x, cache, cur_len, cfg, active, block_tables):
    """One-token paged decode. x: (B, 1, d); cache: dict(k, v) paged
    pools (n_blocks, block_size, KVH, hd) shared across slots; cur_len:
    (B,) int32 lengths INCLUDING this step's token for active slots;
    active: (B,) bool; block_tables: (B, C) int32, possibly a leading
    gather-width slice of the full table.

    The K/V write goes into ``cache`` IN PLACE (inactive slots' entries
    stay byte-identical); the attention runs through the paged
    flash-decode kernel. Returns out (B, 1, d)."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, params["wq"]).reshape(B, 1, H, hd)
    k = dense(x, params["wk"]).reshape(B, 1, KVH, hd)
    v = dense(x, params["wv"]).reshape(B, 1, KVH, hd)
    pos = (cur_len - 1).reshape(-1, 1)
    if cfg.rope_theta:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    paged_write(cache["k"], k[:, 0], block_tables, cur_len, active)
    paged_write(cache["v"], v[:, 0], block_tables, cur_len, active)
    o = flash_decode_paged(q[:, 0].contiguous(), cache["k"], cache["v"],
                           cur_len, block_tables, 1.0 / (hd ** 0.5),
                           window=cfg.sliding_window)
    return dense(o.reshape(B, 1, H * hd), params["wo"])


def init_paged_cache(cfg, n_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Paged KV pool: blocks are shared across slots and indexed through
    per-slot block tables."""
    KVH, hd = cfg.n_kv_heads, cfg.hd
    shape = (n_blocks, block_size, KVH, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
