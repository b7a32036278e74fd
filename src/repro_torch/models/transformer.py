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
    for k and v (one rank's shard when n_blocks is its n_loc)."""
    require_attn_mlp(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cpu", W: int = 1):
    """Stacked per-layer contiguous KV, one rank's strided shard:
    (layers, batch, S_max / W, KVH, hd) for k and v."""
    require_attn_mlp(cfg)
    one = attention.init_cache(cfg, batch, max_len, dtype, device, W)
    return {k: v[None].repeat(cfg.n_layers, *(1,) * v.dim())
            for k, v in one.items()}


def copy_paged_block(cfg, caches, src: int, dst: int):
    """Copy pool block ``src`` to ``dst`` in every layer's K and V, IN
    PLACE — the device half of the serving layer's copy-on-write.
    ``caches`` leaves are tensors (one rank) or per-rank shard lists;
    over W ranks global block t lives on rank t // n_loc at t % n_loc,
    and a copy between ranks goes through the receiving rank's
    device."""
    for leaf in caches.values():
        if isinstance(leaf, torch.Tensor):
            leaf[:, dst] = leaf[:, src]
            continue
        n_loc = leaf[0].shape[1]
        leaf[dst // n_loc][:, dst % n_loc].copy_(
            leaf[src // n_loc][:, src % n_loc])
    return caches


def _layer(tree, li):
    return {k: v[li] for k, v in tree.items()}


def decode(params, x, caches, cur_len, cfg, active, block_tables,
           bounded: bool = True):
    """One-token step through every layer. params, x (B, 1, d), cur_len
    (B,), active (B,) and block_tables (B, C) (or None: contiguous
    caches): one entry per distinct device; caches: {"k", "v"} lists of
    per-rank stacked shards, written IN PLACE (inactive slots leave
    every cache entry unchanged). Returns x per device."""
    require_attn_mlp(cfg)
    layers = [p["layers"] for p in params]
    for li in range(cfg.n_layers):
        lp = [{k: _layer(t[k], li) for k in ("ln1", "attn", "ln2", "mlp")}
              for t in layers]
        h = [apply_norm(p["ln1"], xd, cfg.norm) for p, xd in zip(lp, x)]
        cache = {k: [c[li] for c in v] for k, v in caches.items()}
        y = attention.decode_attn_step([p["attn"] for p in lp], h, cache,
                                       cur_len, cfg, active, block_tables,
                                       bounded)
        x = [xd + yd for xd, yd in zip(x, y)]
        h = [apply_norm(p["ln2"], xd, cfg.norm) for p, xd in zip(lp, x)]
        x = [xd + mlp.apply_mlp_decode(p["mlp"], hd, cfg)
             for p, xd, hd in zip(lp, x, h)]
    return x
