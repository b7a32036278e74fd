"""Layer stack, ``attn_mlp`` (port of ``repro.models.transformer``):
the full-sequence forward (train/prefill) and the decode step.

Parameters keep the JAX scan layout: every layer leaf is stacked with a
leading ``n_layers`` dim (``stack_spec``); both paths walk the layers in
a Python loop, indexing the stacked leaves. Both take per-rank lists:
the full-sequence forward per-rank parameter trees of shards
(``lm.shard_params``) and per-rank sequence shards. The other blocks
(``attn_moe``, ``mamba_hybrid``, ``rwkv``) belong to a later slice of
the port.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp
from repro_torch.models.layers import apply_norm, norm_spec
from repro_torch.models.module import stack_layer_specs


def require_attn_mlp(cfg):
    if cfg.block != "attn_mlp":
        raise NotImplementedError(
            f"block {cfg.block!r} ({cfg.name}) is not ported yet: the first "
            f"slice of the port covers attn_mlp only; MoE, Mamba2/zamba2 "
            f"and RWKV6 come with the other-families slice")


def _ckpt(fn, cfg):
    """Per-layer remat: ``remat_policy="full"`` recomputes the whole
    layer in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``cfg.remat=False`` keeps every activation. The JAX package's
    ``"dots"`` policy (save the matmul outputs) is not ported yet."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' is not ported yet: use 'full' or "
            "remat=False")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


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


def _attn_mlp_layer(p, x, cfg, positions, seq_sharded):
    h = [apply_norm(pr["ln1"], xr, cfg.norm) for pr, xr in zip(p, x)]
    a = attention.apply_attn([pr["attn"] for pr in p], h, cfg,
                             positions=positions)
    x = [xr + ar for xr, ar in zip(x, a)]
    h = [apply_norm(pr["ln2"], xr, cfg.norm) for pr, xr in zip(p, x)]
    m = mlp.apply_mlp_ranks([pr["mlp"] for pr in p], h, cfg,
                            seq_sharded=seq_sharded)
    return [xr + mr for xr, mr in zip(x, m)]


_PARTS = ("ln1", "attn", "ln2", "mlp")


def forward(params, x, cfg, *, positions):
    """The full-sequence forward over the W ranks of the ambient mesh (W
    = 1 included): ``params`` per-rank backbone trees, ``x`` per-rank
    (B, S/W, d) sequence shards of the embedded input (rank r's rows;
    (B, S, d) on every rank when S does not divide by W), ``positions``
    (1, S). Returns (x per rank, aux_loss); the aux loss of a dense
    stack is 0.0. Remat wraps each layer's body over every rank."""
    require_attn_mlp(cfg)
    seq_sharded = positions.shape[-1] % len(x) == 0
    body = _ckpt(_attn_mlp_layer, cfg)
    for li in range(cfg.n_layers):
        lp = [{k: _layer(p["layers"][k], li) for k in _PARTS}
              for p in params]
        x = body(lp, x, cfg, positions, seq_sharded)
    return x, torch.zeros((), dtype=torch.float32, device=x[0].device)


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
        lp = [{k: _layer(t[k], li) for k in _PARTS} for t in layers]
        h = [apply_norm(p["ln1"], xd, cfg.norm) for p, xd in zip(lp, x)]
        cache = {k: [c[li] for c in v] for k, v in caches.items()}
        y = attention.decode_attn_step([p["attn"] for p in lp], h, cache,
                                       cur_len, cfg, active, block_tables,
                                       bounded)
        x = [xd + yd for xd, yd in zip(x, y)]
        h = [apply_norm(p["ln2"], xd, cfg.norm) for p, xd in zip(lp, x)]
        x = [xd + mlp.apply_mlp(p["mlp"], hd, cfg)
             for p, xd, hd in zip(lp, x, h)]
    return x
