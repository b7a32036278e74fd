"""Layer stack, dense / MoE / hybrid (zamba2) / RWKV6 (port of
``repro.models.transformer``): the full-sequence forward (train/prefill)
and the decode step.

Parameters keep the JAX scan layout: every layer leaf is stacked with a
leading ``n_layers`` dim (``stack_spec``); both paths walk the layers in
a Python loop, indexing the stacked leaves. ``attn_moe`` is
``attn_mlp`` with the MoE layer as its FFN (``models/moe.py``). The
zamba2 hybrid (``mamba_hybrid``) runs groups of ``attn_every`` Mamba2
layers, each group followed by the ONE shared attention+MLP block
(``shared_attn``, its parameters reused by every group), then a tail of
``n_layers % attn_every`` Mamba2 layers; ``rwkv`` stacks RWKV6 blocks.

The full-sequence forward takes per-rank lists (per-rank parameter
trees of shards, ``lm.shard_params``, and per-rank sequence shards);
``attn_moe`` and the recurrent blocks run it at one rank. The decode
step runs over W ranks: attention on the W-rank KV pool, the FFN and
the recurrent layers once per distinct device on replicated weights.

Decode state (``init_paged_caches``/``init_caches``): the attention KV
stacked by its layers (``n_layers``, or the hybrid's ``n_groups =
n_layers // attn_every`` shared-block calls), the recurrent state per
slot, (layers, B, ...): ``{"k", "v"}`` for the attention blocks,
``{"mamba": {"conv", "ssm"}, "attn": {"k", "v"}}`` for the hybrid,
``{"x_prev_t", "x_prev_c", "S"}`` for rwkv. Decode writes every leaf IN
PLACE; inactive slots keep theirs byte-identical.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mamba2, mlp, moe, rwkv6
from repro_torch.models.layers import apply_norm, norm_spec
from repro_torch.models.module import stack_layer_specs


PORTED_BLOCKS = ("attn_mlp", "attn_moe", "mamba_hybrid", "rwkv")
RECURRENT_BLOCKS = ("mamba_hybrid", "rwkv")


def require_ported(cfg):
    if cfg.block not in PORTED_BLOCKS:
        raise NotImplementedError(
            f"block {cfg.block!r} ({cfg.name}) is not ported: the port "
            f"covers {', '.join(PORTED_BLOCKS)}")


def require_one_rank(cfg, W: int):
    """Raise for a block whose full-sequence forward (training) runs at
    one rank only."""
    if W <= 1:
        return
    if cfg.block == "attn_moe":
        raise NotImplementedError(
            f"{cfg.name}: training attn_moe over {W} ranks (expert "
            f"parallelism: JAX's experts/expert_mlp rules) is not ported "
            f"yet (ROADMAP queue 1, item 11b); train it at --tp 1")
    if cfg.block in RECURRENT_BLOCKS:
        raise NotImplementedError(
            f"{cfg.name}: training {cfg.block} over {W} ranks (JAX's "
            f"ssm_inner/conv_width rules) is not ported yet (ROADMAP "
            f"queue 1, item 11f); train it at --tp 1")


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


def _attn_block_spec(cfg, ffn):
    return {"ln1": norm_spec(cfg.d_model, cfg.norm),
            "attn": attention.attn_spec(cfg),
            "ln2": norm_spec(cfg.d_model, cfg.norm),
            **ffn}


def layer_spec(cfg):
    require_ported(cfg)
    if cfg.block == "attn_moe":
        return _attn_block_spec(cfg, {"moe": moe.moe_spec(cfg)})
    if cfg.block == "mamba_hybrid":
        return {"ln1": norm_spec(cfg.d_model, cfg.norm),
                "mamba": mamba2.mamba_spec(cfg)}
    if cfg.block == "rwkv":
        return rwkv6.rwkv_spec(cfg)
    return _attn_block_spec(cfg, {"mlp": mlp.mlp_spec(cfg)})


def stack_spec(cfg):
    spec = {"layers": stack_layer_specs(layer_spec(cfg), cfg.n_layers)}
    if cfg.block == "mamba_hybrid" and cfg.attn_every:
        spec["shared_attn"] = _attn_block_spec(cfg,
                                               {"mlp": mlp.mlp_spec(cfg)})
    return spec


def _every(cfg) -> int:
    return cfg.attn_every or cfg.n_layers


def kv_layers(cfg) -> int:
    """Attention calls a step: the KV caches' stacked dim."""
    if cfg.block == "mamba_hybrid":
        return cfg.n_layers // _every(cfg)
    return 0 if cfg.block == "rwkv" else cfg.n_layers


# ------------------------------------------------------------ decode state
def _stacked(one: dict, n: int) -> dict:
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in one.items()}


def paged_kv(cfg, n_blocks: int, block_size: int, dtype=torch.bfloat16,
             device="cpu"):
    """Stacked paged KV: (kv_layers, n_blocks, block_size, KVH, hd) for
    k and v (one rank's shard when n_blocks is its n_loc); None for
    rwkv."""
    n = kv_layers(cfg)
    return _stacked(attention.init_paged_cache(
        cfg, n_blocks, block_size, dtype, device), n) if n else None


def contiguous_kv(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu", W: int = 1):
    """Stacked contiguous KV, one rank's strided shard: (kv_layers,
    batch, S_max / W, KVH, hd) for k and v; None for rwkv."""
    n = kv_layers(cfg)
    return _stacked(attention.init_cache(
        cfg, batch, max_len, dtype, device, W), n) if n else None


def recurrent_state(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """Per-slot recurrent state, stacked by layer, (n_layers, batch,
    ...): the Mamba2 conv window (``dtype``) and SSM state (fp32), or the
    RWKV6 shifted inputs (``dtype``) and WKV state (fp32); None for the
    attention blocks."""
    if cfg.block == "mamba_hybrid":
        return _stacked(mamba2.init_mamba_cache(cfg, batch, dtype, device),
                        cfg.n_layers)
    if cfg.block == "rwkv":
        return _stacked(rwkv6.init_rwkv_state(cfg, batch, dtype, device),
                        cfg.n_layers)
    return None


def assemble(cfg, kv, rec):
    """The caches tree of ``cfg``'s block from its KV and recurrent
    parts (module docstring)."""
    if cfg.block == "mamba_hybrid":
        return {"mamba": rec, "attn": kv}
    return rec if cfg.block == "rwkv" else kv


def kv_part(cfg, caches):
    """The attention KV of ``caches`` ({"k", "v"}), or None."""
    if cfg.block == "mamba_hybrid":
        return caches["attn"]
    return None if cfg.block == "rwkv" else caches


def recurrent_part(cfg, caches):
    """The recurrent state of ``caches``, or None."""
    if cfg.block == "mamba_hybrid":
        return caches["mamba"]
    return caches if cfg.block == "rwkv" else None


def init_paged_caches(cfg, batch: int, n_blocks: int, block_size: int,
                      dtype=torch.bfloat16, device="cpu"):
    """One rank's paged decode state: the paged KV pool and the per-slot
    recurrent state (paging applies to the KV axis only)."""
    require_ported(cfg)
    return assemble(cfg, paged_kv(cfg, n_blocks, block_size, dtype, device),
                    recurrent_state(cfg, batch, dtype, device))


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cpu", W: int = 1):
    """One rank's contiguous decode state: the strided KV shard and the
    per-slot recurrent state."""
    require_ported(cfg)
    return assemble(cfg, contiguous_kv(cfg, batch, max_len, dtype, device,
                                       W),
                    recurrent_state(cfg, batch, dtype, device))


def copy_paged_block(cfg, caches, src: int, dst: int):
    """Copy pool block ``src`` to ``dst`` in every attention layer's K
    and V, IN PLACE — the device half of the serving layer's
    copy-on-write; recurrent state is untouched. The KV leaves are
    tensors (one rank) or per-rank shard lists; over W ranks global
    block t lives on rank t // n_loc at t % n_loc, and a copy between
    ranks goes through the receiving rank's device."""
    kv = kv_part(cfg, caches)
    for leaf in (kv or {}).values():
        if isinstance(leaf, torch.Tensor):
            leaf[:, dst] = leaf[:, src]
            continue
        n_loc = leaf[0].shape[1]
        leaf[dst // n_loc][:, dst % n_loc].copy_(
            leaf[src // n_loc][:, src % n_loc])
    return caches


# ------------------------------------------------------------------ forward
def _layer(tree, li):
    """Layer ``li`` of a stacked parameter (or state) tree."""
    return {k: v[li] if isinstance(v, torch.Tensor) else _layer(v, li)
            for k, v in tree.items()}


def _attn_mlp_layer(p, x, cfg, positions, seq_sharded):
    """One layer over the ranks: (x per rank, the layer's aux loss, or
    None for a dense layer)."""
    h = [apply_norm(pr["ln1"], xr, cfg.norm) for pr, xr in zip(p, x)]
    a = attention.apply_attn([pr["attn"] for pr in p], h, cfg,
                             positions=positions)
    x = [xr + ar for xr, ar in zip(x, a)]
    h = [apply_norm(pr["ln2"], xr, cfg.norm) for pr, xr in zip(p, x)]
    if "moe" in p[0]:
        (y, aux), = [moe.apply_moe(pr["moe"], hr, cfg)
                     for pr, hr in zip(p, h)]       # one rank
        return [x[0] + y], aux
    m = mlp.apply_mlp_ranks([pr["mlp"] for pr in p], h, cfg,
                            seq_sharded=seq_sharded)
    return [xr + mr for xr, mr in zip(x, m)], None


def _mamba_layer(p, x, cfg):
    return x + mamba2.apply_mamba(p["mamba"], apply_norm(p["ln1"], x,
                                                         cfg.norm), cfg)


def _rwkv_layer(p, x, cfg):
    return rwkv6.apply_rwkv_block(p, x, cfg)


def _parts(cfg):
    return ("ln1", "attn", "ln2",
            "moe" if cfg.block == "attn_moe" else "mlp")


def _forward_recurrent(params, x, cfg, positions):
    """The hybrid's and rwkv's full-sequence forward at one rank. Remat
    wraps each Mamba2 layer, each shared-block call and each RWKV6
    block."""
    (p,), (x,) = params, x
    layers = p["layers"]
    if cfg.block == "rwkv":
        body = _ckpt(_rwkv_layer, cfg)
        for li in range(cfg.n_layers):
            x = body(_layer(layers, li), x, cfg)
        return [x]
    every = _every(cfg)
    n_groups = cfg.n_layers // every
    body = _ckpt(_mamba_layer, cfg)
    shared = _ckpt(_attn_mlp_layer, cfg)
    for li in range(cfg.n_layers):
        x = body(_layer(layers, li), x, cfg)
        if (li + 1) % every == 0 and li < n_groups * every:
            (x,), _ = shared([p["shared_attn"]], [x], cfg, positions, True)
    return [x]


def forward(params, x, cfg, *, positions):
    """The full-sequence forward over the W ranks of the ambient mesh (W
    = 1 included; ``attn_moe`` and the recurrent blocks at W = 1 only):
    ``params`` per-rank backbone trees, ``x`` per-rank (B, S/W, d)
    sequence shards of the embedded input (rank r's rows; (B, S, d) on
    every rank when S does not divide by W), ``positions`` (1, S).
    Returns (x per rank, aux_loss): the sum of the layers' MoE aux
    losses, 0.0 for the other blocks. Remat wraps each layer's body over
    every rank."""
    require_ported(cfg)
    require_one_rank(cfg, len(x))
    total = torch.zeros((), dtype=torch.float32, device=x[0].device)
    if cfg.block in RECURRENT_BLOCKS:
        return _forward_recurrent(params, x, cfg, positions), total
    seq_sharded = positions.shape[-1] % len(x) == 0
    body = _ckpt(_attn_mlp_layer, cfg)
    for li in range(cfg.n_layers):
        lp = [{k: _layer(p["layers"][k], li) for k in _parts(cfg)}
              for p in params]
        x, aux = body(lp, x, cfg, positions, seq_sharded)
        if aux is not None:
            total = total + aux
    return x, total


# ------------------------------------------------------------------- decode
def _attn_block_decode(lp, x, cache, cur_len, cfg, active, block_tables,
                       bounded):
    """One attention block's decode step, ``lp`` per device, ``cache``
    {"k", "v"} of this block's per-rank shards."""
    h = [apply_norm(p["ln1"], xd, cfg.norm) for p, xd in zip(lp, x)]
    y = attention.decode_attn_step([p["attn"] for p in lp], h, cache,
                                   cur_len, cfg, active, block_tables,
                                   bounded)
    x = [xd + yd for xd, yd in zip(x, y)]
    h = [apply_norm(p["ln2"], xd, cfg.norm) for p, xd in zip(lp, x)]
    return [xd + _ffn_decode(p, hd, cfg) for p, xd, hd in zip(lp, x, h)]


def _kv_at(kv, i):
    return {k: [c[i] for c in v] for k, v in kv.items()}


def _state_at(rec, d, li):
    """Device ``d``'s layer-``li`` views of the per-device recurrent
    leaves."""
    return {k: v[d][li] for k, v in rec.items()}


def decode(params, x, caches, cur_len, cfg, active, block_tables,
           bounded: bool = True):
    """One-token step through every layer. params, x (B, 1, d), cur_len
    (B,), active (B,) and block_tables (B, C) (or None: contiguous
    caches): one entry per distinct device; caches: the block's tree
    (module docstring) whose KV leaves are lists of per-rank stacked
    shards and whose recurrent leaves are lists with one copy per
    distinct device, all written IN PLACE (inactive slots leave every
    entry unchanged). The FFN (the MLP, or the MoE layer on replicated
    experts, its aux loss dropped as in JAX) and the recurrent layers
    run once per device. Returns x per device."""
    require_ported(cfg)
    layers = [p["layers"] for p in params]
    kv, rec = kv_part(cfg, caches), recurrent_part(cfg, caches)
    if cfg.block == "rwkv":
        for li in range(cfg.n_layers):
            x = [rwkv6.apply_rwkv_decode(_layer(t, li), xd,
                                         _state_at(rec, d, li), cfg, a)
                 for d, (t, xd, a) in enumerate(zip(layers, x, active))]
        return x
    if cfg.block == "mamba_hybrid":
        every = _every(cfg)
        n_groups = cfg.n_layers // every
        shared = [p["shared_attn"] for p in params]
        for li in range(cfg.n_layers):
            x = [xd + mamba2.apply_mamba_decode(
                     lp["mamba"], apply_norm(lp["ln1"], xd, cfg.norm),
                     _state_at(rec, d, li), cfg, a)
                 for d, (lp, xd, a) in enumerate(zip(
                     [_layer(t, li) for t in layers], x, active))]
            if (li + 1) % every == 0 and li < n_groups * every:
                x = _attn_block_decode(shared, x, _kv_at(kv, li // every),
                                       cur_len, cfg, active, block_tables,
                                       bounded)
        return x
    for li in range(cfg.n_layers):
        lp = [{k: _layer(t[k], li) for k in _parts(cfg)} for t in layers]
        x = _attn_block_decode(lp, x, _kv_at(kv, li), cur_len, cfg, active,
                               block_tables, bounded)
    return x


def _ffn_decode(p, h, cfg):
    if "moe" in p:
        return moe.apply_moe(p["moe"], h, cfg)[0]
    return mlp.apply_mlp(p["mlp"], h, cfg)
