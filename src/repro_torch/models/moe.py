"""Mixture-of-Experts layer (port of ``repro.models.moe``: olmoe 64e/top-8,
mixtral 8e/top-2).

Sort-based capacity routing, as in JAX:

1. top-k expert choice per token, per batch row (rows are the routing
   groups);
2. stable argsort by expert id; position within expert = offset from the
   segment start; choices past capacity C drop;
3. gather into a dense (B, E, C, D) dispatch buffer; the per-expert
   products are ONE batched GEMM launch each (``matmul_batched``, the
   experts' (E, B*C, D) rows against their stacked weights);
4. gather-combine with gate weights.

Over W ranks (training, :func:`apply_moe_ranks`) each rank runs its
share of the experts, as JAX's sharding rules place them, on the
gathered sequence, and the partial combines are reduce-scattered; the
decode step (:func:`apply_moe_decode`) all-reduces them.

:func:`apply_moe` returns the Switch aux load-balance loss alongside,
:func:`apply_moe_ranks` its statistics (me, fe). No op here
syncs with the host (no ``nonzero``, boolean-mask indexing, ``unique``
or ``.item()``): the routing replays inside a megatick's CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collective_matmul as cm
from repro_torch.distributed import context as dctx
from repro_torch.kernels import symm
from repro_torch.kernels.matmul import matmul_batched
from repro_torch.models.layers import dense
from repro_torch.models.module import Param


def moe_spec(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    return {
        "router": Param((d, E), init="scaled", axes=("embed", None)),
        "wg": Param((E, d, f), init="scaled",
                    axes=("experts", "embed", "expert_mlp")),
        "wu": Param((E, d, f), init="scaled",
                    axes=("experts", "embed", "expert_mlp")),
        "wd": Param((E, f, d), init="scaled",
                    axes=("experts", "expert_mlp", "embed")),
    }


def capacity(cfg, tokens_per_group: int) -> int:
    """Slots per expert and group: the JAX package's rule (round up to 8
    from 8 on; at most K * T, so decode keeps C tiny)."""
    c = int(cfg.moe_top_k * tokens_per_group / cfg.moe_num_experts
            * cfg.moe_capacity_factor)
    c = max(1, c)
    if c >= 8:
        c = -(-c // 8) * 8
    return min(c, max(1, cfg.moe_top_k * tokens_per_group))


def route(x, router_w, cfg):
    """x: (B, T, D). Returns the dispatch/combine metadata of JAX's
    ``route`` (int64 index fields): ``token_of_slot`` (B, E, C),
    ``slot_valid`` (B, E, C), ``expert_of_flat``, ``slot_of_flat`` and
    ``kept_flat`` (B, T*K), ``gate`` (B, T, K), ``aux`` (scalar) and
    ``C``. The router product runs in fp32 on the GEMM kernel; the top-k
    is a stable descending sort, so ties go to the lower expert id as
    ``lax.top_k``'s do."""
    B, T, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = capacity(cfg, T)
    dev = x.device
    logits = dense(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[..., :K], eidx[..., :K]                 # (B, T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = eidx.reshape(B, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # (B, T*K)
    sorted_e = torch.take_along_dim(flat_e, order, dim=-1)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)           # (B, E)
    seg_start_of = torch.take_along_dim(starts, sorted_e, dim=-1)
    seg_pos = torch.arange(T * K, device=dev)[None, :] - seg_start_of
    keep = seg_pos < C

    # dispatch indices: (e, c) -> flat choice index
    cand = starts[:, :, None] + torch.arange(C, device=dev)  # (B, E, C)
    ends = torch.cat([starts[:, 1:],
                      torch.full((B, 1), T * K, device=dev)], dim=1)
    valid = cand < ends[:, :, None]
    cand = cand.clamp_max(T * K - 1)
    flat_choice = torch.take_along_dim(
        order, cand.reshape(B, E * C), dim=-1).reshape(B, E, C)
    token_of_slot = flat_choice // K

    # combine side: each (t, k) choice -> (expert, slot, kept); inv is
    # the inverse permutation of order (flat -> sorted position)
    inv = torch.argsort(order, dim=-1, stable=True)
    slot_of_flat = torch.take_along_dim(seg_pos, inv, dim=-1)
    kept_flat = torch.take_along_dim(keep, inv, dim=-1)

    # aux load-balance loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    top1 = (eidx[..., :1] == torch.arange(E, device=dev)).float()
    fe = top1.mean(dim=(0, 1))
    return dict(token_of_slot=token_of_slot, slot_valid=valid,
                expert_of_flat=flat_e, slot_of_flat=slot_of_flat,
                kept_flat=kept_flat, gate=gate, aux=switch_aux(me, fe),
                me=me, fe=fe, C=C)


def switch_aux(me, fe):
    """The Switch load-balance loss E * sum_e me_e * fe_e of the mean
    router probabilities ``me`` (E,) and top-1 fractions ``fe`` (E,)."""
    return me.shape[-1] * (me * fe).sum()


def global_aux(stats: list):
    """The aux loss of D data groups' MoE layers, JAX's over the global
    batch: ``stats`` holds per group the list of its layers' (me, fe)
    (equal rows a group, or the whole batch in each); each layer's me
    and fe are averaged over the groups before the product (a mean of
    the groups' products is not JAX's aux), and the layers' losses
    summed, on the first group's device."""
    dev = stats[0][0][0].device if stats[0] else None
    total = None
    for layer in zip(*stats):
        me = torch.stack([m.to(dev) for m, _ in layer]).mean(dim=0)
        fe = torch.stack([f.to(dev) for _, f in layer]).mean(dim=0)
        a = switch_aux(me, fe)
        total = a if total is None else total + a
    return total


def _combine_share(params, x, r, cfg, lo: int):
    """The combine of the experts ``params`` holds (its ``wg`` (e, d, f)
    are experts [lo, lo + e) of the E, each with its ``f`` columns of
    d_ff) over ``x`` (B, T, D) routed by ``r``: (B, T, D) fp32, each
    (t, k) choice's expert output weighted by its gate (cast to the
    activation dtype first, as JAX does) and summed over k in fp32;
    choices whose expert lies outside the share add nothing."""
    B, T, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = r["C"]
    e = params["wg"].shape[0]

    # dispatch: (B, e, C, D), invalid slots zeroed; then the experts'
    # rows (e, B*C, D)
    tos = r["token_of_slot"][:, lo:lo + e]
    xe = torch.take_along_dim(x, tos.reshape(B, e * C, 1),
                              dim=1).reshape(B, e, C, D)
    xe = torch.where(r["slot_valid"][:, lo:lo + e, :, None], xe, 0.0)
    xe = xe.transpose(0, 1).reshape(e, B * C, D).contiguous()

    dt = x.dtype
    g = _bmm(xe, params["wg"].to(dt))
    u = _bmm(xe, params["wu"].to(dt))
    h = F.silu(g) * u
    ye = _bmm(h, params["wd"].to(dt))                        # (e, B*C, D)
    ye = ye.reshape(e, B, C, D).transpose(0, 1).reshape(B, e * C, D)

    # combine: gather each (t, k)'s expert output, weight by its gate
    eof, kept = r["expert_of_flat"], r["kept_flat"]
    if e < E:
        eof = eof - lo
        kept = kept & (eof >= 0) & (eof < e)
        eof = eof.clamp(0, e - 1)
    lin = eof * C + r["slot_of_flat"].clamp_max(C - 1)
    vals = torch.take_along_dim(ye, lin[..., None], dim=1)  # (B, T*K, D)
    vals = torch.where(kept[..., None], vals, 0.0)
    vals = vals.reshape(B, T, K, D)
    gate = r["gate"].to(dt).float()
    return (vals.float() * gate[..., None]).sum(dim=2)


def _bmm(a, b):
    """``matmul_batched``; experts cut over ``data`` on their ``embed``
    dim (``cm.Stationary``) block by block, weights-stationary."""
    if isinstance(b, cm.Stationary):
        return cm.stationary(lambda x, bs: [matmul_batched(x, bs[0])], a,
                             [b], kdim=1)[0]
    return matmul_batched(a, b)


def apply_moe(params, x, cfg):
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar), every expert on
    this rank. The expert weights are cast to ``x``'s dtype per call, as
    in JAX (a no-op for the serving storage)."""
    r = route(x, params["router"], cfg)
    return _combine_share(params, x, r, cfg, 0).to(x.dtype), r["aux"]


def apply_moe_decode(params, x, cfg, split):
    """The decode layer (S = 1) over the W ranks of the ambient mesh,
    JAX's ``apply_moe`` on sharded experts: params per rank, placed as
    :func:`apply_moe_ranks` places them and as ``split`` (the layer's
    ``lm.split_axes``) names it (``"experts"``: olmoe's experts over the
    ranks; ``"expert_mlp"``: mixtral's columns; None: every expert
    whole, where E % W != 0); x per distinct device (B, 1, D),
    replicated. Each device routes once on its replicated router; each
    rank runs its share of the three expert products (one batched launch
    each) and weights its partial combine by the gates; the partials are
    all-reduced in fp32 in rank order (``cm.all_reduce_devices``). Whole
    experts (or W = 1) run
    :func:`apply_moe` once per device. The aux loss is dropped, as in
    JAX's decode. Returns per device (B, 1, D)."""
    dev = dctx.by_device(params)
    if split["wg"] is None:
        return [apply_moe(p, xd, cfg)[0] for p, xd in zip(dev, x)]
    mesh = dctx.current().mesh
    n = cfg.moe_num_experts // mesh.size if split["wg"] == "experts" else 0
    routes = mesh.per_rank([route(xd, p["router"], cfg)
                            for p, xd in zip(dev, x)])
    xr = mesh.per_rank(x)
    parts = [_combine_share(p, xr[i], routes[i], cfg, r * n)
             for i, (r, p) in enumerate(zip(symm.rank_ids(params, mesh),
                                            params))]
    return [t.to(x[0].dtype)
            for t in cm.all_reduce_devices(parts, mesh.distinct)]


def apply_moe_ranks(params, x, cfg, *, seq_sharded: bool):
    """The train/prefill layer over the W ranks of the ambient mesh (at W
    = 1 :func:`apply_moe`'s numbers). params: per rank the layer's shards by
    JAX's rules (``experts`` over ``model``: rank r holds experts [r E/W,
    (r+1) E/W); mixtral's overrides: every expert, its d_ff / W columns;
    E % W != 0: every expert whole, the recorded degradation); x: per
    rank (B, T/W, D), the rank's rows (``seq_sharded``), or (B, T, D).

    Routing groups are batch rows (capacity over a row's T*K choices),
    so every rank first gathers the rows' whole sequences and routes them
    identically on its replicated router; it runs its share of the three
    expert products (one batched launch each), weights its partial
    combine by the gates, and the partials are reduce-scattered in fp32,
    in rank order, to the ranks' rows (``cm.reduce_scatter``; summed on
    every rank when T does not divide by W). Where the experts are
    replicated each rank computes the whole layer and keeps its rows.
    Returns (per rank the layout of ``x``, rank 0's Switch statistics
    (me, fe), so they count once: :func:`switch_aux` makes the aux loss,
    :func:`global_aux` that of several data groups)."""
    W = len(x)
    xf = cm.all_gather(x, gather_axis=1) if seq_sharded and W > 1 else x
    E, f = cfg.moe_num_experts, cfg.d_ff
    whole = tuple(params[0]["wg"].shape[::2]) == (E, f)
    parts, stats = [], None
    for rank, (p, xr) in enumerate(zip(params, xf)):
        rt = route(xr, p["router"], cfg)
        stats = stats or (rt["me"], rt["fe"])
        parts.append(_combine_share(p, xr, rt, cfg,
                                    rank * p["wg"].shape[0] % E))
    dt = x[0].dtype
    if whole:
        if seq_sharded and W > 1:
            m = x[0].shape[1]
            parts = [t.narrow(1, r * m, m) for r, t in enumerate(parts)]
        return [t.to(dt) for t in parts], stats
    out = (cm.reduce_scatter(parts, scatter_axis=1) if seq_sharded
           else cm.all_reduce(parts))
    return [t.to(dt) for t in out], stats
