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

The Switch aux load-balance loss is returned alongside. No op here
syncs with the host (no ``nonzero``, boolean-mask indexing, ``unique``
or ``.item()``): the routing replays inside a megatick's CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    aux = E * (me * fe).sum()
    return dict(token_of_slot=token_of_slot, slot_valid=valid,
                expert_of_flat=flat_e, slot_of_flat=slot_of_flat,
                kept_flat=kept_flat, gate=gate, aux=aux, C=C)


def apply_moe(params, x, cfg):
    """x: (B, T, D) -> (out (B, T, D), aux_loss scalar). The expert
    weights are cast to ``x``'s dtype per call, as in JAX (a no-op for
    the serving storage)."""
    B, T, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    r = route(x, params["router"], cfg)
    C = r["C"]

    # dispatch: (B, E, C, D), invalid slots zeroed; then the experts'
    # rows (E, B*C, D)
    xe = torch.take_along_dim(x, r["token_of_slot"].reshape(B, E * C, 1),
                              dim=1).reshape(B, E, C, D)
    xe = torch.where(r["slot_valid"][..., None], xe, 0.0)
    xe = xe.transpose(0, 1).reshape(E, B * C, D).contiguous()

    dt = x.dtype
    g = matmul_batched(xe, params["wg"].to(dt))
    u = matmul_batched(xe, params["wu"].to(dt))
    h = F.silu(g) * u
    ye = matmul_batched(h, params["wd"].to(dt))              # (E, B*C, D)
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine: gather each (t, k)'s expert output, weight by its gate
    # (cast to the activation dtype first, as JAX does), sum in fp32
    lin = r["expert_of_flat"] * C + r["slot_of_flat"].clamp_max(C - 1)
    vals = torch.take_along_dim(ye, lin[..., None], dim=1)  # (B, T*K, D)
    vals = torch.where(r["kept_flat"][..., None], vals, 0.0)
    vals = vals.reshape(B, T, K, D)
    gate = r["gate"].to(dt).float()
    out = (vals.float() * gate[..., None]).sum(dim=2)
    return out.to(dt), r["aux"]
