"""Layer stack, ``attn_mlp`` decode path (port of
``repro.models.transformer``).

Parameters keep the JAX scan layout: every layer leaf is stacked with a
leading ``n_layers`` dim (``stack_spec``); decode walks the layers in a
Python loop, indexing the stacked leaves. The other blocks (``attn_moe``,
``mamba_hybrid``, ``rwkv``) belong to a later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, mlp
from repro_torch.models.layers import apply_norm, norm_spec
from repro_torch.models.module import stack_layer_specs


def require_attn_mlp(cfg):
    if cfg.block != "attn_mlp":
        raise NotImplementedError(
            f"block {cfg.block!r} ({cfg.name}) is not ported yet: the first "
            f"slice of the port covers attn_mlp only; MoE, Mamba2/zamba2 "
            f"and RWKV6 come with the other-families slice")


def layer_spec(cfg):
    require_attn_mlp(cfg)
    return {"ln1": norm_spec(cfg.d_model, cfg.norm),
            "attn": attention.attn_spec(cfg),
            "ln2": norm_spec(cfg.d_model, cfg.norm),
            "mlp": mlp.mlp_spec(cfg)}


def stack_spec(cfg):
    return {"layers": stack_layer_specs(layer_spec(cfg), cfg.n_layers)}


def init_paged_caches(cfg, batch: int, n_blocks: int, block_size: int,
                      dtype=torch.bfloat16, device="cpu"):
    """Stacked per-layer paged KV: (layers, n_blocks, block_size, KVH, hd)
    for k and v."""
    require_attn_mlp(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def copy_paged_block(cfg, caches, src: int, dst: int):
    """Copy pool block ``src`` to ``dst`` in every layer's K and V, IN
    PLACE — the device half of the serving layer's copy-on-write."""
    for leaf in caches.values():
        leaf[:, dst] = leaf[:, src]
    return caches


def decode(params, x, caches, cur_len, cfg, active, block_tables):
    """One-token step through every layer. x: (B, 1, d); caches: the
    stacked paged pools, written IN PLACE; cur_len: (B,) lengths
    including this token for active slots; active: (B,) bool (inactive
    slots leave every cache entry unchanged); block_tables: (B, C).
    Returns x."""
    require_attn_mlp(cfg)
    layers = params["layers"]
    ln1, attn, ln2, ffn = (layers["ln1"], layers["attn"], layers["ln2"],
                           layers["mlp"])
    for li in range(cfg.n_layers):
        h = apply_norm({k: v[li] for k, v in ln1.items()}, x, cfg.norm)
        cache = {"k": caches["k"][li], "v": caches["v"][li]}
        x = x + attention.decode_attn_step(
            {k: v[li] for k, v in attn.items()}, h, cache, cur_len, cfg,
            active, block_tables)
        h = apply_norm({k: v[li] for k, v in ln2.items()}, x, cfg.norm)
        x = x + mlp.apply_mlp_decode({k: v[li] for k, v in ffn.items()},
                                     h, cfg)
    return x
