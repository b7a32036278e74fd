"""GQA attention (port of ``repro.models.attention``): the train/prefill
path at W = 1 (:func:`apply_attn` over the dense or the blockwise
attention, in fp32 plain PyTorch as JAX computes it outside Pallas), and
the decode step over the paged pool and the contiguous strided cache, on
one rank or over the W ranks of the ambient mesh.

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


def apply_attn(params, x, cfg, *, positions=None, dense_threshold=2048):
    """Train/prefill attention at W = 1. x: (B, S, d_model). wq/wk/wv
    are one grouped GEMM call, wo one call; the KV heads are repeated up
    to the query heads (GQA) before the fp32 attention."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = dense_group(x, [params["wq"], params["wk"], params["wv"]])
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    rep = H // KVH
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / (hd ** 0.5)
    prefix = cfg.num_prefix_tokens if cfg.prefix_lm else None
    if S <= dense_threshold:
        o = dense_attention(q, k, v, scale=scale, causal=cfg.causal,
                            window=cfg.sliding_window, prefix_len=prefix)
    else:
        o = blockwise_attention(q, k, v, scale=scale, causal=cfg.causal,
                                window=cfg.sliding_window, prefix_len=prefix,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_kv=cfg.attn_chunk_kv)
    return dense(o.reshape(B, S, H * hd), params["wo"])


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
