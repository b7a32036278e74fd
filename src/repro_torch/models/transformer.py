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
trees of shards, ``lm.shard_params``, and per-rank sequence shards), for
every block: the dense block at the paper's sequence-parallel sites, the
MoE layer with its experts over the ranks (``moe.apply_moe_ranks``), the
Mamba2 and RWKV6 blocks on the gathered sequence
(``mamba2.apply_mamba_ranks``, ``rwkv6.apply_rwkv_block_ranks``), the
hybrid's shared attention block as the dense one. The decode
step runs over W ranks on per-rank weights (JAX's serve step on
``param_shardings``): attention on the W-rank KV pool, the projections
on each rank's shards at the decode sites (``core.patterns``), the
activations and the recurrent state once per distinct device; where the
weights are replicated (``lm.replicate``), each layer runs once per
device.

Decode state (``init_paged_caches``/``init_caches``): the attention KV
stacked by its layers (``n_layers``, or the hybrid's ``n_groups =
n_layers // attn_every`` shared-block calls), the recurrent state per
slot, (layers, B, ...): ``{"k", "v"}`` for the attention blocks,
``{"mamba": {"conv", "ssm"}, "attn": {"k", "v"}}`` for the hybrid,
``{"x_prev_t", "x_prev_c", "S"}`` for rwkv. Decode writes every leaf IN
PLACE; inactive slots keep theirs byte-identical.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import collective_matmul as cm
from repro_torch.distributed import context as dctx
from repro_torch.kernels import symm
from repro_torch.distributed import fsdp
from repro_torch.kernels.matmul import DOT_OPS as DOT_KERNELS
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


# what the "dots" policy saves: JAX's ``checkpoint_dots`` saves every
# ``dot_general`` output; here the GEMM kernel's recording route and the
# plain products the training attention and the scans run (``einsum``
# lowers to ``bmm``)
DOT_OPS = frozenset(DOT_KERNELS + (torch.ops.aten.mm.default,
                                   torch.ops.aten.bmm.default,
                                   torch.ops.aten.addmm.default,
                                   torch.ops.aten.baddbmm.default))


def _dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ckpt(fn, cfg):
    """Per-layer remat (``torch.utils.checkpoint``, non-reentrant):
    ``remat_policy="full"`` recomputes the whole layer in the backward;
    ``"dots"`` (JAX's ``checkpoint_dots``) saves the output of every
    product in the layer (:data:`DOT_OPS`, a selective checkpoint) and
    recomputes only the elementwise chains, so the backward relaunches
    no forward product; ``cfg.remat=False`` keeps every activation."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=ctx)
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
    ranks goes through the receiving rank's device. Where other processes
    hold ranks of the ambient mesh the lists hold this process's ranks:
    a block that crosses processes goes through one exchange of every
    rank's candidate (``kernels.symm.every_rank``: the source block on its
    owner, zeros elsewhere), which every process makes."""
    kv = kv_part(cfg, caches)
    mesh = dctx.current().mesh
    for leaf in (kv or {}).values():
        if isinstance(leaf, torch.Tensor):
            leaf[:, dst] = leaf[:, src]
            continue
        n_loc = leaf[0].shape[1]
        ids = symm.rank_ids(leaf, mesh)
        s_own, d_own = src // n_loc, dst // n_loc
        # one process holds both ranks (every process decides alike)
        if s_own // len(leaf) == d_own // len(leaf):
            if d_own in ids:
                leaf[ids.index(d_own)][:, dst % n_loc].copy_(
                    leaf[ids.index(s_own)][:, src % n_loc])
        else:
            block = symm.every_rank(
                [t[:, src % n_loc] if r == s_own
                 else torch.zeros_like(t[:, src % n_loc])
                 for r, t in zip(ids, leaf)], mesh)[s_own]
            if d_own in ids:
                leaf[ids.index(d_own)][:, dst % n_loc].copy_(block)
    return caches


# ------------------------------------------------------------------ forward
def _layer(tree, li):
    """Layer ``li`` of a stacked parameter (or state) tree (an FSDP
    leaf's blocks sliced, ``distributed.fsdp.Shards``)."""
    return {k: v[li] if isinstance(v, (torch.Tensor, fsdp.Shards,
                                       cm.Stationary))
            else _layer(v, li) for k, v in tree.items()}


def _attn_mlp_layer(p, x, cfg, positions, seq_sharded):
    """One layer over the ranks: (x per rank, the MoE layer's Switch
    statistics (me, fe), ``moe.apply_moe_ranks``, or None for a dense
    layer)."""
    h = [apply_norm(pr["ln1"], xr, cfg.norm) for pr, xr in zip(p, x)]
    a = attention.apply_attn([pr["attn"] for pr in p], h, cfg,
                             positions=positions)
    x = [xr + ar for xr, ar in zip(x, a)]
    h = [apply_norm(pr["ln2"], xr, cfg.norm) for pr, xr in zip(p, x)]
    if "moe" in p[0]:
        y, stats = moe.apply_moe_ranks([pr["moe"] for pr in p], h, cfg,
                                       seq_sharded=seq_sharded)
        return [xr + yr for xr, yr in zip(x, y)], stats
    m = mlp.apply_mlp_ranks([pr["mlp"] for pr in p], h, cfg,
                            seq_sharded=seq_sharded)
    return [xr + mr for xr, mr in zip(x, m)], None


def _mamba_layer(p, x, cfg, seq_sharded):
    h = [apply_norm(pr["ln1"], xr, cfg.norm) for pr, xr in zip(p, x)]
    m = mamba2.apply_mamba_ranks([pr["mamba"] for pr in p], h, cfg,
                                 seq_sharded=seq_sharded)
    return [xr + mr for xr, mr in zip(x, m)]


def _rwkv_layer(p, x, cfg, seq_sharded):
    return rwkv6.apply_rwkv_block_ranks(p, x, cfg, seq_sharded=seq_sharded)


def _parts(cfg):
    return ("ln1", "attn", "ln2",
            "moe" if cfg.block == "attn_moe" else "mlp")


def _body(fn, cfg, params):
    """A layer's body under remat (:func:`_ckpt`), gathering the layer's
    FSDP shards first where ``params`` are a data group's views
    (``distributed.fsdp``), inside the remat scope."""
    return _ckpt(fsdp.gathering(fn) if fsdp.is_view(params) else fn, cfg)


def _forward_recurrent(params, x, cfg, positions, seq_sharded):
    """The hybrid's and rwkv's full-sequence forward over the ranks.
    Remat wraps each Mamba2 layer, each shared-block call (the dense
    W-rank block) and each RWKV6 block."""
    layers = [p["layers"] for p in params]
    if cfg.block == "rwkv":
        body = _body(_rwkv_layer, cfg, params)
        for li in range(cfg.n_layers):
            x = body([_layer(t, li) for t in layers], x, cfg, seq_sharded)
        return x
    every = _every(cfg)
    n_groups = cfg.n_layers // every
    body = _body(_mamba_layer, cfg, params)
    shared = _body(_attn_mlp_layer, cfg, params)
    for li in range(cfg.n_layers):
        x = body([_layer(t, li) for t in layers], x, cfg, seq_sharded)
        if (li + 1) % every == 0 and li < n_groups * every:
            x, _ = shared([p["shared_attn"] for p in params], x, cfg,
                          positions, seq_sharded)
    return x


def forward(params, x, cfg, *, positions):
    """The full-sequence forward over the W ranks of the ambient mesh (W
    = 1 included), every block: ``params`` per-rank backbone trees,
    ``x`` per-rank (B, S/W, d) sequence shards of the embedded input
    (rank r's rows; (B, S, d) on every rank when S does not divide by
    W), ``positions`` (1, S). Returns (x per rank, the list of the MoE
    layers' Switch statistics (me, fe), each counted once, not once a
    rank; empty for the other blocks), which ``models.lm`` makes the aux
    loss of (``moe.global_aux``: over a data mesh the groups' averaged
    before the product). Remat wraps each layer's body over every rank; on a data
    group's views (``distributed.fsdp``) the body gathers the layer's
    FSDP shards first."""
    require_ported(cfg)
    seq_sharded = positions.shape[-1] % len(x) == 0
    if cfg.block in RECURRENT_BLOCKS:
        return _forward_recurrent(params, x, cfg, positions, seq_sharded), []
    body = _body(_attn_mlp_layer, cfg, params)
    stats = []
    for li in range(cfg.n_layers):
        lp = [{k: _layer(p["layers"][k], li) for k in _parts(cfg)}
              for p in params]
        x, st = body(lp, x, cfg, positions, seq_sharded)
        if st is not None:
            stats.append(st)
    return x, stats


# ------------------------------------------------------------------- decode
def _layers(trees, li, keys=None):
    """Layer ``li`` of each per-rank stacked tree (its ``keys``, or all),
    sliced once per distinct tree (the ranks of one device share a
    replicated one)."""
    seen: dict = {}
    for t in trees:
        if id(t) not in seen:
            seen[id(t)] = _layer(t if keys is None else
                                 {k: t[k] for k in keys}, li)
    return [seen[id(t)] for t in trees]


def _attn_block_decode(lp, x, cache, cur_len, cfg, active, block_tables,
                       bounded, split):
    """One attention block's decode step, ``lp`` per rank, ``x`` per
    device, ``cache`` {"k", "v"} of this block's per-rank shards,
    ``split`` the block's ``lm.split_axes``."""
    dev = dctx.by_device(lp)
    h = [apply_norm(p["ln1"], xd, cfg.norm) for p, xd in zip(dev, x)]
    y = attention.decode_attn_step([p["attn"] for p in lp], h, cache,
                                   cur_len, cfg, active, block_tables,
                                   bounded, split=split["attn"])
    x = [xd + yd for xd, yd in zip(x, y)]
    h = [apply_norm(p["ln2"], xd, cfg.norm) for p, xd in zip(dev, x)]
    return [xd + fd for xd, fd in zip(x, _ffn_decode(lp, h, cfg, split))]


def _kv_at(kv, i):
    return {k: [c[i] for c in v] for k, v in kv.items()}


def _state_at(rec, li):
    """Every device's layer-``li`` views of the per-device recurrent
    leaves."""
    n = len(next(iter(rec.values())))
    return [{k: v[d][li] for k, v in rec.items()} for d in range(n)]


def decode(params, x, caches, cur_len, cfg, active, block_tables,
           bounded: bool = True, *, split):
    """One-token step through every layer. params: one backbone tree per
    rank of the ambient mesh (its shards by the sharding rules, or the
    replicated weights of its device; one tree at W = 1); x (B, 1, d),
    cur_len (B,), active (B,) and block_tables (B, C) (or None:
    contiguous caches): one entry per distinct device; caches: the
    block's tree (module docstring) whose KV leaves are lists of
    per-rank stacked shards and whose recurrent leaves are lists with
    one copy per distinct device, all written IN PLACE (inactive slots
    leave every entry unchanged). Every layer takes per-rank weights and
    returns per-device activations: attention on the W-rank KV pool, the
    FFN (the MLP, or the MoE layer, its aux loss dropped as in JAX) and
    the recurrent layers on their shards, or once per device where the
    weights are whole. ``split``: the backbone's ``lm.split_axes`` tree
    (every leaf None for whole weights), which tells each site which of
    its weights are a rank's block. Returns x per device."""
    require_ported(cfg)
    layers = [p["layers"] for p in params]
    kv, rec = kv_part(cfg, caches), recurrent_part(cfg, caches)
    if cfg.block == "rwkv":
        for li in range(cfg.n_layers):
            x = rwkv6.apply_rwkv_decode_ranks(
                _layers(layers, li), x, _state_at(rec, li), cfg, active,
                split["layers"])
        return x
    if cfg.block == "mamba_hybrid":
        every = _every(cfg)
        n_groups = cfg.n_layers // every
        shared = [p["shared_attn"] for p in params]
        for li in range(cfg.n_layers):
            lp = _layers(layers, li)
            dev = dctx.by_device(lp)
            h = [apply_norm(p["ln1"], xd, cfg.norm) for p, xd in zip(dev, x)]
            y = mamba2.apply_mamba_decode_ranks(
                [p["mamba"] for p in lp], h, _state_at(rec, li), cfg, active,
                split["layers"]["mamba"])
            x = [xd + yd for xd, yd in zip(x, y)]
            if (li + 1) % every == 0 and li < n_groups * every:
                x = _attn_block_decode(shared, x, _kv_at(kv, li // every),
                                       cur_len, cfg, active, block_tables,
                                       bounded, split["shared_attn"])
        return x
    for li in range(cfg.n_layers):
        lp = _layers(layers, li, _parts(cfg))
        x = _attn_block_decode(lp, x, _kv_at(kv, li), cur_len, cfg, active,
                               block_tables, bounded, split["layers"])
    return x


def _ffn_decode(lp, h, cfg, split):
    if "moe" in lp[0]:
        return moe.apply_moe_decode([p["moe"] for p in lp], h, cfg,
                                    split["moe"])
    return mlp.apply_mlp_decode([p["mlp"] for p in lp], h, cfg, split["mlp"])
