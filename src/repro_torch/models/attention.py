"""GQA attention (port of ``repro.models.attention``): the train/prefill
path (:func:`apply_attn` over the dense or the blockwise attention, in
fp32 plain PyTorch as JAX computes it outside Pallas, on one rank or
over W ranks, each rank on its heads), and the decode step
over the paged pool and the contiguous strided cache, on one rank or
over the W ranks of the ambient mesh.

Values in the decode step: ``params`` one tree per rank (its shards by
the sharding rules, ``lm.shard_params``, or the replicated weights of
its device); ``x``, ``cur_len``, ``active`` and ``block_tables`` lists
with one entry per distinct device of the mesh (one entry at W = 1); the
caches lists of per-rank shards (``distributed.context``)."""
from __future__ import annotations

import torch

from repro_torch.core import collective_matmul as cm
from repro_torch.core import flash_decode as fd
from repro_torch.core import patterns
from repro_torch.distributed import context as dctx
from repro_torch.kernels import symm
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models.layers import apply_rope, dense, dense_group
from repro_torch.models.module import Param

NEG_INF = torch.finfo(torch.float32).min


def attn_spec(cfg):
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": Param((d, H * hd), init="scaled", axes=("embed", "heads")),
        "wk": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wv": Param((d, KVH * hd), init="scaled", axes=("embed", "kv_heads")),
        "wo": Param((H * hd, d), init="scaled", axes=("heads", "embed")),
    }


def _mask_bias(q_pos, kv_pos, *, causal, window, prefix_len):
    """(q, kv) additive fp32 bias (0 or NEG_INF)."""
    ok = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        c = q_pos[:, None] >= kv_pos[None, :]
        if prefix_len is not None:
            c = c | (kv_pos[None, :] < prefix_len)
        ok = ok & c
    if window is not None:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def dense_attention(q, k, v, *, scale, causal=True, window=None,
                    prefix_len=None):
    """Oracle / small-sequence path. q, k, v: (B, S, H, D) (kv
    repeated); the S x S scores in fp32."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    bias = _mask_bias(pos, pos, causal=causal, window=window,
                      prefix_len=prefix_len)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s + bias, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def _divisor_chunk(S: int, want: int) -> int:
    """The largest divisor of S that is <= want (vlm prefixes make S
    odd-sized)."""
    c = min(want, S)
    while S % c:
        c -= 1
    return c


def blockwise_attention(q, k, v, *, scale, causal=True, window=None,
                        prefix_len=None, chunk_q=512, chunk_kv=1024):
    """Flash-style blockwise attention in plain PyTorch (no S x S
    buffer): a loop over q chunks, an inner loop over kv chunks carrying
    the online-softmax state, with JAX's ``isfinite`` guards. Chunk pairs
    that are fully masked are skipped (JAX skips them with ``lax.cond``);
    the test is on Python ints, so nothing waits for the device."""
    B, S, H, D = q.shape
    cq, ck = _divisor_chunk(S, chunk_q), _divisor_chunk(S, chunk_kv)

    def kv_needed(qi, ki):
        q_lo, q_hi = qi * cq, qi * cq + cq - 1
        k_lo, k_hi = ki * ck, ki * ck + ck - 1
        need = True
        if causal:
            need = k_lo <= q_hi or (prefix_len is not None
                                    and k_lo < prefix_len)
        if window is not None:
            need = need and k_hi > q_lo - window
        return need

    outs = []
    for qi in range(S // cq):
        qf = q[:, qi * cq:(qi + 1) * cq].float()
        q_pos = qi * cq + torch.arange(cq, device=q.device)
        acc = torch.zeros((B, H, cq, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        for ki in range(S // ck):
            if not kv_needed(qi, ki):
                continue
            kv_pos = ki * ck + torch.arange(ck, device=q.device)
            bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                              prefix_len=prefix_len)
            s = torch.einsum("bqhd,bkhd->bhqk", qf,
                             k[:, ki * ck:(ki + 1) * ck].float()) * scale
            s = s + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v[:, ki * ck:(ki + 1) * ck].float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))     # (B, cq, H, D)
    return torch.cat(outs, dim=1)


def _attention(q, k, v, cfg, S, dense_threshold):
    scale = 1.0 / (cfg.hd ** 0.5)
    prefix = cfg.num_prefix_tokens if cfg.prefix_lm else None
    if S <= dense_threshold:
        return dense_attention(q, k, v, scale=scale, causal=cfg.causal,
                               window=cfg.sliding_window, prefix_len=prefix)
    return blockwise_attention(q, k, v, scale=scale, causal=cfg.causal,
                               window=cfg.sliding_window, prefix_len=prefix,
                               chunk_q=cfg.attn_chunk_q,
                               chunk_kv=cfg.attn_chunk_kv)


def apply_attn(params, x, cfg, *, positions=None, dense_threshold=2048):
    """Train/prefill attention over the W ranks of the ambient mesh.
    params: per rank {"wq", "wk", "wv" column shards, "wo" row shard};
    x: per rank (B, S/W, d), the rank's rows, or (B, S, d) (every row,
    when S does not divide by W); positions (1, S). wq, wk and wv share
    the AG+GEMM site and wo is the GEMM+RS site (``core.patterns``, as
    in JAX); each rank attends with its query heads over the whole
    sequence, the KV heads repeated up to the query heads (GQA) before
    the fp32 attention. One rank is W = 1 (wq/wk/wv one grouped GEMM
    launch, wo one); a tensor ``params``/``x`` pair is that rank.

    A rank's k/v columns hold the KV heads its query heads use when the
    heads divide by W (KVH 8, W 4 at full width); otherwise (KVH 1 in
    ``smoke_config``: the 32 k columns split mid-head) every rank
    gathers the k/v columns first, as it does the q columns when the
    query heads do not divide by W (then every rank computes every head
    and keeps its columns of the output). Returns per rank the layout
    of ``x``."""
    if not isinstance(x, list):
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return apply_attn([params], [x], cfg, positions=positions,
                          dense_threshold=dense_threshold)[0]
    W = len(x)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = positions.shape[-1]
    for name, n in (("wq", H * hd), ("wk", KVH * hd), ("wv", KVH * hd)):
        if params[0][name].shape[-1] * W != n:
            raise ValueError(
                f"attention {name}: per-rank columns "
                f"{params[0][name].shape[-1]} x {W} ranks != {n}; the "
                f"train sites take column-sharded weights "
                f"(lm.shard_params)")
    q, k, v = patterns.project_up(
        x, [[p[n] for p in params] for n in ("wq", "wk", "wv")],
        seq_axis_sharded=x[0].shape[1] * W == S)
    heads_local = H % W == 0
    kv_local = heads_local and KVH % W == 0
    if not heads_local:
        q = cm.all_gather(q, gather_axis=-1)
    if not kv_local:
        k = cm.all_gather(k, gather_axis=-1)
        v = cm.all_gather(v, gather_axis=-1)
    hq, kvh = (H // W, KVH // W) if kv_local else (
        H // W if heads_local else H, KVH)
    rep = H // KVH
    out = []
    for r in range(W):
        B = q[r].shape[0]
        pos = positions.to(q[r].device)
        qr = q[r].reshape(B, S, hq, hd)
        kr = k[r].reshape(B, S, kvh, hd)
        vr = v[r].reshape(B, S, kvh, hd)
        if cfg.rope_theta:
            qr = apply_rope(qr, pos, cfg.rope_theta)
            kr = apply_rope(kr, pos, cfg.rope_theta)
        kr = kr.repeat_interleave(rep, dim=2)
        vr = vr.repeat_interleave(rep, dim=2)
        if not kv_local and heads_local:        # the rank's query heads
            kr = kr[:, :, r * hq:(r + 1) * hq]
            vr = vr[:, :, r * hq:(r + 1) * hq]
        o = _attention(qr, kr, vr, cfg, S, dense_threshold).reshape(
            B, S, hq * hd)
        if not heads_local:                     # the rank's columns
            n = H * hd // W
            o = o[..., r * n:(r + 1) * n]
        out.append(o)
    return patterns.project_down(out, [p["wo"] for p in params])


def _qkv(params, x, cur_len, cfg):
    """q (B, H, hd), k/v (B, KVH, hd) of this step, RoPE at cur_len - 1;
    the three projections are one grouped GEMM call."""
    return _heads(*dense_group(x, [params["wq"], params["wk"],
                                   params["wv"]]), cur_len, cfg)


def _qkv_ranks(params, x, cur_len, cfg, split):
    """:func:`_qkv` on every distinct device over per-rank weights: the
    column-parallel q/k/v (one grouped GEMM a rank over its head
    columns, where ``split`` names an axis) gathered whole to every
    device, then the heads and RoPE. Whole weights run once per
    device."""
    names = ("wq", "wk", "wv")
    qkv = patterns.gather_columns(
        x, [[p[n] for p in params] for n in names],
        [split[n] is not None for n in names])
    return [_heads(q, k, v, cl, cfg) for q, k, v, cl in zip(*qkv, cur_len)]


def _heads(q, k, v, cur_len, cfg):
    B = q.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, KVH, hd)
    v = v.reshape(B, 1, KVH, hd)
    pos = (cur_len - 1).reshape(-1, 1)
    if cfg.rope_theta:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q[:, 0].contiguous(), k[:, 0], v[:, 0]


def decode_attn_step(params, x, cache, cur_len, cfg, active,
                     block_tables=None, bounded: bool = True, *, split):
    """One-token decode. params: per rank {"wq", "wk", "wv" column
    blocks, "wo" row block} (or whole, where the rules replicate them;
    ``split``, the block's ``lm.split_axes``, says which);
    x: per device (B, 1, d); cache: dict(k, v) of
    per-rank shards -- paged pools (n_loc, block_size, KVH, hd) with
    ``block_tables`` (per device (B, C) int32, possibly a leading
    gather-width slice), else strided caches (B, S_max / W, KVH, hd);
    cur_len: per device (B,) int32 lengths INCLUDING this step's token
    for active slots; active: per device (B,) bool.

    The K/V write goes into the cache IN PLACE (inactive slots' entries
    stay byte-identical). Attention and ``wo`` run through the fusion
    mode's patterns at W > 1 (``core.patterns``): q/k/v column-parallel
    and gathered to every device (the KV cache is sequence-sharded and
    holds every KV head), ``wo`` at the row-parallel site; at W = 1
    through the paged or strided flash-decode kernel and the GEMM.
    ``bounded`` (W > 1, paged) picks the table walk over the masked
    whole-shard oracle. Over a mesh with data groups (the ambient
    ``DistContext.data``; ``params`` data group 0's model ranks) the
    caches are laid out over that whole mesh and attended there
    (:func:`_attn_data`). Returns per device out (B, 1, d)."""
    ctx = dctx.current()
    mesh = ctx.mesh
    W = symm.width(cache["k"], mesh)
    B = x[0].shape[0]
    H, hd = cfg.n_heads, cfg.hd
    scale = 1.0 / (hd ** 0.5)
    if W == 1 or (ctx.data is not None and mesh is None):
        qkv = [_qkv(params[0], x[0], cur_len[0], cfg)]
    else:
        qkv = _qkv_ranks(params, x, cur_len, cfg, split)
    if ctx.data is not None:
        o = _attn_data(cfg, ctx.data, *qkv[0], cache, cur_len, active,
                       block_tables, bounded, scale).reshape(B, 1, H * hd)
        if mesh is None:
            return [dense(o, params[0]["wo"])]
        out = patterns.project_k_sharded(
            [cm.to_device(o, d) for d in mesh.devices],
            [p["wo"] for p in params], rows=split["wo"] is not None)
        return mesh.from_ranks(out)
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
        [t.reshape(B, 1, H * hd) for t in o], [p["wo"] for p in params],
        rows=split["wo"] is not None)
    return mesh.from_ranks(out)


def _attn_data(cfg, data, q, k, v, cache, cur_len, active, block_tables,
               bounded, scale):
    """The attention of a decode step over a mesh with data groups
    (``data``; the KV state's layout, ``models.lm``), from the whole q
    (B, H, hd), k and v (B, KVH, hd) of this step; returns o (B, H, hd)
    on q's device. The paged pool is one pool over every rank of the
    mesh: the write on the block's owner, each rank's partial over its
    blocks and the combine over the D x M sources (the W-rank path
    over the whole mesh, its fused kernel under ``pallas``). The
    contiguous caches hold each data group's rows (``Mesh.rows``) over
    its model sub-mesh: each group writes and attends its rows there,
    and the groups' outputs are joined over ``data`` (where the batch
    does not divide, every group runs every row on its copy and the
    first group's output is kept). Over processes each attends its own
    groups' rows and the rows are joined across them
    (``patterns.join_groups``); the paged pool's combine spans every
    rank of the job."""
    mode = dctx.current().fusion_mode
    if block_tables is not None:
        def per(t):
            return [cm.to_device(t, d) for d in data.devices]
        with dctx.use(dctx.DistContext(data, mode)):
            o, _, _ = patterns.decode_attn_paged(
                per(q), per(k), per(v), cache["k"], cache["v"],
                data.per_rank(cur_len), data.per_rank(block_tables),
                scale=scale, window=cfg.sliding_window,
                active=data.per_rank(active), bounded=bounded)
        return cm.to_device(o[0], q.device)
    M, B = data.model, q.shape[0]
    cl, act = data.per_rank(cur_len), data.per_rank(active)
    outs = []
    for g in data.local_groups:
        grp, rows = data.group(g), data.rows(g, B)
        # this process's ranks of group g, as indices of its lists
        ranks = [r - data.first for r in range(g * M, (g + 1) * M)
                 if r in data.local]

        def sel(t):
            return [cm.to_device(t[rows], d) for d in grp.devices]
        part = {n: [cache[n][r] for r in ranks] for n in ("k", "v")}
        with dctx.use(dctx.DistContext(grp if grp.size > 1 else None,
                                       mode)):
            og = _strided(cfg, sel(q), sel(k), sel(v), part,
                          [cl[r][rows] for r in ranks],
                          [act[r][rows] for r in ranks], scale)
        outs.append(cm.to_device(og[0], q.device))
    if B % data.dp:
        return outs[0]
    return patterns.join_groups(outs, q.device)


def _strided(cfg, q, k, v, cache, cur_len, active, scale):
    """Contiguous strided cache: ownership write + attention (at W = 1
    the contiguous flash-decode kernel's single-source path). A window
    at least as long as the cache makes it a rolling ring (positions
    wrap modulo S_max, the cache holds the last S_max tokens)."""
    W = symm.width(cache["k"], dctx.current().mesh)
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
