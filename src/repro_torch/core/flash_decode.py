"""Distributed flash decode (port of ``repro.core.flash_decode``).

Single rank: the paged KV write and the dense references. W ranks: the
paper's §4.2 decode over a sequence-sharded KV cache, as loops over the
ranks of a :class:`~repro_torch.distributed.context.Mesh`.

Layouts (shared with ``serving.kv_cache`` and ``models.attention``):

* **paged** -- the pool is ``(n_blocks, block_size, KVH, D)``; logical
  position ``p`` of slot ``b`` lives at pool block
  ``tables[b, p // block_size]``, offset ``p % block_size``; ``-1`` is
  an unallocated entry or a reclaim hole. Over W ranks the pool is
  sharded on the block dim in contiguous chunks: global block t lives
  on rank ``t // n_loc`` at local index ``t % n_loc``.
* **contiguous (strided)** -- each rank holds ``(B, S_max / W, KVH, D)``;
  local slot j of rank r holds global position ``j * W + r``.

A *partial* is the triple ``(o, m, l)``: o = sum exp(s - m) V
(unnormalised), m the running max, l = sum exp(s - m), all fp32.
Sharded arguments are lists of per-rank tensors; the ``q``, ``cur_len``,
``tables``, ``k_new``/``v_new`` and ``active`` arguments of the W-rank
functions take one tensor per rank too (ranks on one device may pass
the same tensor). Rank-to-rank moves are copies onto the receiving
rank's device.

Combine schedules (``mode``): ``bsp`` gathers every partial and folds
them in rank order; ``ring`` folds each neighbour's partial as it
arrives; ``rs_ag`` reduce-scatters over heads and all-gathers;
``pallas`` is the fused kernel (``kernels.flash_decode``), which pushes
the partial to every rank and folds the sources in rank order inside
the kernel. Outputs are per-rank lists. Where other processes hold
ranks of the mesh (``Mesh.spans``), the lists hold this process's ranks
(entry i is global rank ``mesh.first + i``), W is the mesh's, and the
combines take the other ranks' partials through ``kernels.symm``
(:func:`~repro_torch.kernels.symm.every_rank`), folding them exactly as
one process does.

Unlike JAX, every write updates the cache IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.core.collective_matmul import nbytes, record
from repro_torch.kernels import symm

NEG = torch.finfo(torch.float32).min


def lens(cur_len, B: int, device) -> torch.Tensor:
    """A scalar or (B,) length as a (B,) int32 tensor on ``device``."""
    cl = torch.as_tensor(cur_len, device=device)
    return cl.to(torch.int32).reshape(-1).expand(B).contiguous()


# ---------------------------------------------------------------- partials
def local_partial_attention(q, k_shard, v_shard, valid, scale):
    """Partial attention over a local KV shard. q: (B, H, D);
    k_shard/v_shard: (B, S_loc, KVH, D); valid: (B, S_loc) bool.
    Returns (o, m, l): (B, H, D), (B, H), (B, H) fp32; an all-invalid
    row has m = NEG and l = 0."""
    B, H, D = q.shape
    KVH = k_shard.shape[2]
    g = H // KVH
    qg = q.float().reshape(B, KVH, g, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_shard.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(valid[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_shard.float())
    m = torch.where(torch.isfinite(m), m, NEG)
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def combine2(pa, pb):
    """Online-softmax combine of two partials (associative,
    commutative)."""
    oa, ma, la = pa
    ob, mb, lb = pb
    m = torch.maximum(ma, mb)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    ca = torch.where(torch.isfinite(ma), torch.exp(ma - m_safe), 0.0)
    cb = torch.where(torch.isfinite(mb), torch.exp(mb - m_safe), 0.0)
    return (oa * ca[..., None] + ob * cb[..., None], m, la * ca + lb * cb)


def finalize(partial):
    o, _, l = partial
    return o / l.clamp_min(1e-30)[..., None]


def _to(x, dev):
    return tuple(t.to(dev) for t in x)


# ------------------------------------------------------- combine schedules
def _record(op, partials, n=1, scale=1):
    record(op, scale * nbytes(*partials[0]), len(partials), n=n)


def _record_push(B, H, D, W):
    """The fused kernels' push of every rank's fp32 partial (o, m, l) to
    every rank: an all-gather of the W partials."""
    record("all-gather", W * B * H * (D + 2) * 4, W)


def combine_bsp(partials):
    """Paper baseline: every rank gathers every partial, then folds them
    in rank order."""
    _record("all-gather", partials, scale=len(partials))
    out = []
    for r, own in enumerate(partials):
        dev = own[0].device
        acc = _to(partials[0], dev)
        for s in range(1, len(partials)):
            acc = combine2(acc, _to(partials[s], dev))
        out.append(acc)
    return out


def combine_ring(partials):
    """Fine-grained: each of W - 1 steps folds the partial that arrived
    from the left neighbour while passing it on."""
    W = len(partials)
    _record("collective-permute", partials, n=W - 1)
    cur, acc = list(partials), list(partials)
    for _ in range(1, W):
        cur = [_to(cur[(r - 1) % W], acc[r][0].device) for r in range(W)]
        acc = [combine2(acc[r], cur[r]) for r in range(W)]
    return acc


def combine_rs_ag(partials):
    """Beyond-paper: reduce-scatter over heads with the combine op, then
    all-gather (2x the partial on the wire instead of W x); the ring
    when H does not divide by W."""
    W = len(partials)
    H = partials[0][0].shape[1]
    if H % W:
        return combine_ring(partials)
    h = H // W
    _record("reduce-scatter", partials)
    _record("all-gather", partials)

    def hblk(p, s):
        return tuple(t[:, s * h:(s + 1) * h] for t in p)

    acc = [None] * W
    for t in range(W):
        prev = acc
        acc = []
        for i in range(W):
            blk = hblk(partials[i], (i - t - 1) % W)
            acc.append(blk if t == 0 else combine2(
                _to(prev[(i - 1) % W], blk[0].device), blk))
    # rank i now holds the combined head block i: all-gather in rank order
    return [tuple(torch.cat([a[j].to(partials[i][0].device) for a in acc],
                            dim=1) for j in range(3)) for i in range(W)]


_COMBINES = {"bsp": combine_bsp, "ring": combine_ring,
             "rs_ag": combine_rs_ag}


def every_partial(partials, mesh) -> list:
    """Every rank's partial (o, m, l), rank order, from this process's
    ranks' (``partials``): one exchange of the packed (B, H, D + 2)
    rows where other processes hold ranks of ``mesh``, else
    ``partials``."""
    if not symm.split(mesh):
        return list(partials)
    rows = [torch.cat([o, m[..., None], l[..., None]], dim=-1)
            for o, m, l in partials]
    D = partials[0][0].shape[-1]
    return [(t[..., :D], t[..., D], t[..., D + 1])
            for t in symm.every_rank(rows, mesh)]


def _combine(partials, mode, dtype, mesh=None):
    full = every_partial(partials, mesh)
    if len(full) == 1:
        acc = full
    elif mode in _COMBINES:
        acc = _COMBINES[mode](full)
    else:
        raise ValueError(f"unknown decode combine mode {mode!r}")
    return [finalize(acc[r]).to(dtype) for r in symm.rank_ids(partials, mesh)]


# ------------------------------------------------------- contiguous decode
def decode_attention(q, k_shards, v_shards, cur_len, *, scale,
                     mode: str = "ring", window: int | None = None,
                     mesh=None):
    """One decode step of sequence-sharded flash attention over W ranks.

    q, cur_len: per rank, (B, H, D) and a scalar or (B,) (tokens in the
    cache, including the current one); k_shards/v_shards: per rank
    (B, S_loc, KVH, D), strided layout. Returns per-rank (B, H, D)
    outputs. The local partial runs in the contiguous flash-decode
    kernel (its plain version for CPU tensors); ``pallas`` fuses the
    partial, the push and the combine into that kernel, and one rank
    always takes the kernel's single-source path."""
    from repro_torch.kernels import flash_decode as kfd
    B, H, D = q[0].shape
    W = symm.width(k_shards, mesh)
    cl = [lens(c, B, k.device) for c, k in zip(cur_len, k_shards)]
    if mode == "pallas":
        _record_push(B, H, D, W)
    if mode == "pallas" or W == 1:
        return kfd.flash_decode_fused(q, k_shards, v_shards, cl, scale,
                                      window=window, mesh=mesh)
    partials = kfd.flash_decode_partial(q, k_shards, v_shards, cl, scale,
                                        window=window, mesh=mesh)
    return _combine(partials, mode, q[0].dtype, mesh)


def strided_write(shard, new, cur_len, rank: int, W: int, active=None,
                  rolling_len: int | None = None):
    """Write each owning slot's new KV into rank ``rank``'s strided
    shard, IN PLACE: position ``p = cur_len - 1`` (mod ``rolling_len``)
    belongs to rank ``p % W`` at local slot ``p // W``. Slots this rank
    does not own, and inactive slots, rewrite their current value.
    shard: (B, S_loc, KVH, D); new: (B, KVH, D). Returns ``shard``."""
    B, S_loc = shard.shape[:2]
    p = lens(cur_len, B, shard.device).long() - 1
    if rolling_len is not None:
        p = p % rolling_len
    own = (p % W) == rank
    if active is not None:
        own = own & active
    slot = (p.clamp_min(0) // W).clamp_max(S_loc - 1)
    b = torch.arange(B, device=shard.device)
    cur = shard[b, slot]
    shard[b, slot] = torch.where(own[:, None, None], new.to(shard.dtype),
                                 cur)
    return shard


def decode_attention_fused(q, k_new, v_new, k_shards, v_shards, cur_len, *,
                           scale, mode: str = "ring",
                           window: int | None = None,
                           rolling_len: int | None = None, active=None,
                           mesh=None):
    """Cache update + partial attention + combine over W ranks: the
    strided layout makes ownership local, so every rank writes only the
    positions it owns (in place) and attends after the write.
    ``active`` (per rank, (B,) bool or None) gates the write of slots
    that do not consume a token this step. With ``rolling_len`` the
    cache is a ring of that many positions (window = cache size).
    Returns (per-rank outputs, k_shards, v_shards)."""
    W = symm.width(k_shards, mesh)
    act = active if active is not None else [None] * len(k_shards)
    for i, r in enumerate(symm.rank_ids(k_shards, mesh)):
        strided_write(k_shards[i], k_new[i], cur_len[i], r, W, act[i],
                      rolling_len)
        strided_write(v_shards[i], v_new[i], cur_len[i], r, W, act[i],
                      rolling_len)
    eff = cur_len if rolling_len is None else [
        torch.as_tensor(c).clamp_max(rolling_len) for c in cur_len]
    out = decode_attention(q, k_shards, v_shards, eff, scale=scale,
                           mode=mode,
                           window=None if rolling_len is not None else window,
                           mesh=mesh)
    return out, k_shards, v_shards


# ------------------------------------------------------------ paged decode
def gather_paged_view(pool, tables):
    """Logical per-slot view of a paged pool: (B, C*bs, KVH, D) in
    position order. ``-1`` entries gather a clamped garbage block —
    callers mask by ``cur_len``."""
    t = tables.long().clamp(0, pool.shape[0] - 1)
    v = pool[t]                                   # (B, C, bs, KVH, D)
    B, C, bs = v.shape[:3]
    return v.reshape(B, C * bs, *pool.shape[2:])


def gather_owned_blocks(pool, tables, base: int):
    """Each slot's referenced blocks that live on this rank's pool shard
    ``pool`` (n_loc, bs, KVH, D), which holds global blocks
    ``[base, base + n_loc)``. Returns (view (B, C*bs, KVH, D) in logical
    order, owned (B, C) bool); ``-1`` holes and other ranks' blocks
    gather local block 0 as padding with ``owned=False``."""
    n_loc = pool.shape[0]
    t = tables.long()
    owned = (t >= base) & (t < base + n_loc)
    v = pool[torch.where(owned, t - base, 0)]     # (B, C, bs, KVH, D)
    B, C, bs = v.shape[:3]
    return v.reshape(B, C * bs, *pool.shape[2:]), owned


def paged_block_positions(tables, n_loc: int, rank: int, bs: int):
    """Logical positions held by this rank's pool shard, per slot:
    (gpos (B, n_loc, bs), has (B, n_loc) -- whether the slot's table
    references the local block at all)."""
    C = tables.shape[1]
    gb = rank * n_loc + torch.arange(n_loc, device=tables.device)
    match = tables.long()[:, :, None] == gb[None, None, :]  # (B, C, n_loc)
    has = match.any(dim=1)
    chunk = torch.where(match, torch.arange(C, device=tables.device)
                        [None, :, None], 0).amax(dim=1)     # (B, n_loc)
    gpos = chunk[:, :, None] * bs + torch.arange(bs, device=tables.device)
    return gpos, has


def paged_local_partial_attention(q, k_loc, v_loc, valid, scale):
    """Partial attention of every slot over a whole local pool shard
    (S_loc, KVH, D) with a per-slot ``valid`` (B, S_loc) mask."""
    B = q.shape[0]
    return local_partial_attention(q, k_loc.expand(B, *k_loc.shape),
                                   v_loc.expand(B, *v_loc.shape), valid,
                                   scale)


def paged_write(pool, new, tables, cur_len, active, *, owner_base=None,
                n_owned=None):
    """Write each active slot's new KV at position ``cur_len - 1``
    through its table row, IN PLACE. pool: (n_blocks, bs, KVH, D) --
    with ``owner_base``/``n_owned`` set, this rank's shard holding global
    blocks ``[owner_base, owner_base + n_owned)``; new: (B, KVH, D);
    tables: (B, C) (may be a leading column slice); cur_len: (B,);
    active: (B,) bool. Writes of inactive slots, of ``-1`` entries, of
    blocks outside the owned range and of positions past the table slice
    are dropped.

    The drop needs no host sync: every dropped row is redirected to the
    target of the first kept row and carries that row's value, so
    duplicate targets all store the same bytes; with no kept row at all,
    every row rewrites one location with its current value. Kept rows
    have distinct targets (each slot writes a private block). Returns
    ``pool``."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    C = tables.shape[1]
    pos = (cur_len.long() - 1).clamp_min(0)
    chunk = pos // bs
    blk = tables.gather(1, chunk.clamp_max(C - 1)[:, None])[:, 0].long()
    ok = active & (blk >= 0) & (chunk < C)
    if owner_base is not None:
        ok = ok & (blk >= owner_base) & (blk < owner_base + n_owned)
        blk = blk - owner_base
    flat = blk.clamp(0, n_blocks - 1) * bs + pos % bs  # (B,) pool rows
    rows = pool.view(n_blocks * bs, *pool.shape[2:])
    # first kept row (or 0) as a 1-element index: indexing with a 0-d
    # tensor would read it back to the host
    first = torch.argmax(ok.to(torch.int32)).view(1)
    tgt = torch.where(ok, flat, flat[first])
    val = torch.where(ok[:, None, None], new.to(pool.dtype),
                      new[first].to(pool.dtype))
    val = torch.where(ok.any(), val, rows[tgt])
    rows[tgt] = val
    return pool


def decode_paged_attention_fused(q, k_new, v_new, k_pools, v_pools, cur_len,
                                 tables, *, scale, mode: str = "ring",
                                 window: int | None = None, active=None,
                                 bounded: bool = True, mesh=None):
    """Paged decode over W ranks: block-table-translated write into the
    owning rank's shard (in place) + partial attention over each local
    shard + combine. k_pools/v_pools: per rank (n_loc, bs, KVH, D);
    tables: per rank (B, C), possibly a leading gather-width slice;
    cur_len: per rank (B,) lengths including this step's token.

    ``bounded`` (default) walks each slot's table: the paged kernel's
    partial mode, or its fused mode under ``pallas``. ``bounded=False``
    is the masked whole-shard oracle, plain code for CPU tensors only.
    Returns (per-rank outputs, k_pools, v_pools)."""
    from repro_torch.kernels import flash_decode as kfd
    W = symm.width(k_pools, mesh)
    ids = symm.rank_ids(k_pools, mesh)
    n_loc = k_pools[0].shape[0]
    B = q[0].shape[0]
    if not bounded and any(p.device.type != "cpu" for p in k_pools):
        raise ValueError("the masked paged oracle (bounded=False, "
                         "--paged-gather masked) is plain code for CPU "
                         "tensors; on the card the paged kernel walks "
                         "the tables (bounded)")
    act = [torch.ones((B,), dtype=torch.bool, device=k.device)
           if active is None else a
           for k, a in zip(k_pools, active or [None] * len(k_pools))]
    for i, r in enumerate(ids):
        for pools, new in ((k_pools, k_new), (v_pools, v_new)):
            paged_write(pools[i], new[i], tables[i], cur_len[i], act[i],
                        owner_base=r * n_loc, n_owned=n_loc)
    if bounded:
        if mode == "pallas":
            _record_push(B, *q[0].shape[1:], W)
            out = kfd.flash_decode_paged_fused(
                q, k_pools, v_pools, cur_len, tables, scale, window=window,
                mesh=mesh)
            return out, k_pools, v_pools
        partials = kfd.flash_decode_paged_partial(
            q, k_pools, v_pools, cur_len, tables, scale, window=window,
            mesh=mesh)
    else:
        bs = k_pools[0].shape[1]
        partials = []
        for i, r in enumerate(ids):
            gpos, has = paged_block_positions(tables[i], n_loc, r, bs)
            cl = cur_len[i].long()[:, None, None]
            valid = has[:, :, None] & (gpos < cl)
            if window is not None:
                valid = valid & (gpos >= cl - window)
            partials.append(paged_local_partial_attention(
                q[i], k_pools[i].reshape(n_loc * bs, *k_pools[i].shape[2:]),
                v_pools[i].reshape(n_loc * bs, *v_pools[i].shape[2:]),
                valid.reshape(B, n_loc * bs), scale))
        if mode == "pallas":      # the fused kernel folds in rank order
            mode = "bsp"
    return _combine(partials, mode, q[0].dtype, mesh), k_pools, v_pools


# ---------------------------------------------------------------- references
def reference_paged_decode_attention(q, k_pool, v_pool, cur_len, tables,
                                     scale, window: int | None = None):
    """Single-device paged oracle: gather the logical view, then dense
    attention."""
    kview = gather_paged_view(k_pool, tables)
    vview = gather_paged_view(v_pool, tables)
    return reference_decode_attention(q, kview, vview, cur_len, scale,
                                      window=window)


def reference_decode_attention(q, k, v, cur_len, scale,
                               window: int | None = None):
    """Oracle: dense fp32 softmax attention over the first cur_len
    positions. q: (B, H, D); k/v: (B, S, KVH, D); cur_len: (B,) or a
    scalar."""
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cur_len, device=q.device)
    cl = cl.reshape(-1, 1) if cl.dim() else cl
    valid = pos[None, :] < cl
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    valid = valid.expand(B, S)
    qg = q.float().reshape(B, KVH, g, D)
    kT = k.float().transpose(1, 2)                   # (B, KVH, S, D)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kT) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    vT = v.float().transpose(1, 2)
    o = torch.einsum("bkgs,bksd->bkgd", p, vT)
    return o.reshape(B, H, D).to(q.dtype)
