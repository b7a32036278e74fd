"""Flash decode kernels: paged (port of the Pallas
``repro.kernels.flash_decode.flash_decode_paged_fused``) and contiguous
strided (port of ``flash_decode_fused``, the paper's Algorithm 4).

Wrappers (for CUDA tensors they launch the hand-written kernels in
``csrc/flash_decode_paged.cu`` and ``csrc/flash_decode.cu``; for CPU
tensors they run the plain PyTorch versions; a CUDA call the kernel
cannot take raises):

* :func:`flash_decode_paged` -- paged, one rank (W = 1);
* :func:`flash_decode_paged_fused` -- paged over W ranks: every rank's
  partial is pushed to every rank and the sources are combined in rank
  order inside the kernel (outputs bit-identical across ranks);
* :func:`flash_decode_paged_partial` -- each rank's unnormalised partial
  (o, m, l), for the torch-code combines of ``core.flash_decode``;
* :func:`flash_decode_fused` / :func:`flash_decode_partial` -- the same
  two for a contiguous cache sharded in the strided layout (local slot j
  of rank r holds position j * W + r); at W = 1 the fused call is the
  single-source case.

W-rank arguments are per-rank lists (ranks on one device may pass the
same tensor); ranks sharing a device are launched together. Semantics
(kernels and plain versions alike): slot ``b`` attends to the positions
``p < cur_len[b]`` (and ``p >= cur_len[b] - window`` with a window) that
this rank holds; ``-1`` table entries and other ranks' blocks are
skipped; a slot with nothing to attend has m = NEG, l = 0 and comes out
as zeros.

Counters (kernel launches; plain-version calls): ``<wrapper>.launches``
and ``<wrapper>.plain_calls`` on each wrapper. A multi-rank call counts
one launch per device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.flash_decode import (combine2, finalize,
                                           gather_owned_blocks,
                                           local_partial_attention)
from repro_torch.kernels import _build, symm

NEG = torch.finfo(torch.float32).min
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_THREADS, _ACC = 128, 8          # csrc: g * D <= NT * ACCN
NORMAL, PARTIAL, FUSED = 0, 1, 2  # csrc/fd_common.cuh Mode
_SM_COUNT: dict[int, int] = {}


# --------------------------------------------------------- plain versions
def paged_partial_plain(q, k_pool, v_pool, cur_len, tables, scale,
                        window: int | None = None, base: int = 0):
    """One rank's paged partial in plain PyTorch: q (B, H, D); pool shard
    (n_loc, bs, KVH, D) holding global blocks [base, base + n_loc);
    cur_len (B,); tables (B, C) (any strides). Returns fp32 (o, m, l)."""
    B = q.shape[0]
    bs = k_pool.shape[1]
    C = tables.shape[1]
    kview, owned = gather_owned_blocks(k_pool, tables, base)
    vview, _ = gather_owned_blocks(v_pool, tables, base)
    pos = torch.arange(C * bs, device=q.device)
    cl = cur_len.long()[:, None]
    valid = owned.repeat_interleave(bs, dim=1) & (pos[None] < cl)
    if window is not None:
        valid = valid & (pos[None] >= cl - window)
    return local_partial_attention(q, kview, vview, valid.reshape(B, -1),
                                   scale)


def paged_decode_plain(q, k_pool, v_pool, cur_len, tables, scale,
                       window: int | None = None):
    """The W = 1 kernel's function in plain PyTorch (fp32 softmax).

    q: (B, H, D); pools: (n_blocks, bs, KVH, D); cur_len: (B,) int;
    tables: (B, C) int (any strides). Returns (B, H, D) in q's dtype."""
    part = paged_partial_plain(q, k_pool, v_pool, cur_len, tables, scale,
                               window)
    return finalize(part).to(q.dtype)


def strided_partial_plain(q, k_shard, v_shard, cur_len, scale,
                          window: int | None, rank: int, W: int):
    """One rank's partial over its strided shard (B, S_loc, KVH, D):
    local slot j holds position j * W + rank. cur_len: (B,)."""
    S_loc = k_shard.shape[1]
    gpos = torch.arange(S_loc, device=q.device) * W + rank
    cl = cur_len.long()[:, None]
    valid = gpos[None] < cl
    if window is not None:
        valid = valid & (gpos[None] >= cl - window)
    return local_partial_attention(q, k_shard, v_shard, valid, scale)


def fused_plain(partials, dtype):
    """The fused kernels' Part 2 in plain PyTorch: every rank "pushes" its
    partial by a copy into every rank's inbox, and each rank folds its
    inbox in source order 0..W-1."""
    out = []
    for own in partials:
        dev = own[0].device
        inbox = [tuple(t.to(dev, copy=True) for t in p) for p in partials]
        acc = inbox[0]
        for p in inbox[1:]:
            acc = combine2(acc, p)
        out.append(finalize(acc).to(dtype))
    return out


# ------------------------------------------------------------ validation
def _all_cpu(*groups) -> bool:
    return all(t.device.type == "cpu" for g in groups for t in g)


def _check_common(name, q, k, v, cur_len, mesh):
    """Per-rank checks shared by the multi-rank wrappers; returns W."""
    W = len(k)
    if not (len(q) == len(v) == len(cur_len) == W) or W == 0:
        raise ValueError(f"{name}: per-rank lists of different lengths "
                         f"({len(q)}, {len(k)}, {len(v)}, {len(cur_len)})")
    B, H, D = q[0].shape
    for r in range(W):
        if q[r].shape != (B, H, D) or k[r].shape != v[r].shape \
                or k[r].shape != k[0].shape or k[r].shape[-1] != D \
                or H % k[r].shape[-2] or cur_len[r].shape != (B,):
            raise ValueError(f"{name}: rank {r} shapes q {tuple(q[r].shape)}"
                             f", k {tuple(k[r].shape)}, v "
                             f"{tuple(v[r].shape)}, cur_len "
                             f"{tuple(cur_len[r].shape)} do not fit rank 0's")
    if _all_cpu(q, k, v, cur_len):
        return W
    for r in range(W):
        dev = k[r].device
        if dev.type != "cuda" or any(t.device != dev for t in
                                     (q[r], v[r], cur_len[r])):
            raise ValueError(f"{name}: rank {r}'s inputs must all be CPU "
                             f"tensors or on one CUDA device")
        if mesh is not None and mesh.devices[r] != dev:
            raise ValueError(f"{name}: rank {r}'s tensors are on {dev}, "
                             f"the mesh puts it on {mesh.devices[r]}")
        if q[r].dtype not in _DTYPES or k[r].dtype != q[r].dtype \
                or v[r].dtype != q[r].dtype or q[r].dtype != q[0].dtype:
            raise TypeError(f"{name}: kernel takes f32 or bf16 q and caches "
                            f"of the same dtype, got {q[r].dtype}, "
                            f"{k[r].dtype}, {v[r].dtype}")
        if cur_len[r].dtype != torch.int32:
            raise TypeError(f"{name}: cur_len must be int32")
        if not all(t.is_contiguous() for t in (q[r], k[r], v[r],
                                               cur_len[r])):
            raise ValueError(f"{name}: q, caches and cur_len must be "
                             f"contiguous")
    KVH = k[0].shape[-2]
    if D not in _HEAD_DIMS or (H // KVH) * D > _THREADS * _ACC:
        raise ValueError(f"{name}: kernel built for head dims {_HEAD_DIMS} "
                         f"with (H/KVH)*D <= {_THREADS * _ACC}; got D={D}, "
                         f"H={H}, KVH={KVH}")
    if W > D:
        raise ValueError(f"{name}: at most D={D} ranks")
    return W


def _sm_count(device) -> int:
    idx = torch.device(device).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def n_splits(B: int, KVH: int, C: int, device) -> int:
    """Work units (table entries or tiles) per slot are walked by this
    many blocks: enough (slot, KV head, split) blocks for about two per
    SM, at most C."""
    want = -(-2 * _sm_count(device) // max(B * KVH, 1))
    return max(1, min(C, 16, want))


def _comm_chunks(B: int, H: int, groups, device) -> int:
    """Blocks per rank of the communicating pass: at most four per SM
    over the busiest device's ranks, at most one per (slot, head) row."""
    per_dev = max(len(r) for r in groups.values())
    return max(1, min(B * H, 64, 4 * _sm_count(device) // per_dev))


_TILE = 16                       # csrc/flash_decode.cu TILE


def _lib(paged: bool):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if paged:
        fn = _build.load("flash_decode_paged").fd_paged_launch
        head = [ptr] * 5 + [i32, ptr, i32, ptr, ptr] + [i32] * 8
    else:
        fn = _build.load("flash_decode").fd_launch
        head = [ptr] * 5 + [i32, ptr, ptr] + [i32] * 6
    if fn.argtypes is None:
        fn.argtypes = head + [ctypes.c_float] + [i32] * 4 + [
            ptr, ptr, i32, i32, ctypes.c_uint, ctypes.c_longlong,
            ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, mode, q, k, v, cur_len, scale, window, mesh=None,
            tables=None):
    """Launch the paged (``tables`` given) or strided kernel once per
    device over its local ranks; returns per-rank outputs ((n_local, ...)
    views): (B, H, D) in q's dtype, or fp32 (B, H, D + 2) partials."""
    W = len(k)
    B, H, D = q[0].shape
    KVH = k[0].shape[-2]
    groups = symm.rank_groups(k)
    chunks, call = 0, None
    if mode == FUSED:
        comm = symm.communicator(mesh)
        chunks = _comm_chunks(B, H, groups, k[0].device)
        call = comm.call(B * H * (D + 2) * 4, chunks)
    fn = _lib(tables is not None)
    outs: list = [None] * W
    for dev, ranks in groups.items():
        n_local = len(ranks)
        if n_local > 8:
            raise ValueError(f"{name}: at most 8 ranks per device, got "
                             f"{n_local} on {dev}")
        if tables is not None:
            n_loc, bs = k[0].shape[:2]
            C = tables[0].shape[1]
            n_split = n_splits(B * n_local, KVH, C, dev)
            head = (symm.ptrs([q[r] for r in ranks]),
                    symm.ptrs([k[r] for r in ranks]),
                    symm.ptrs([v[r] for r in ranks]),
                    symm.ptrs([cur_len[r] for r in ranks]),
                    symm.ptrs([tables[r] for r in ranks]),
                    tables[ranks[0]].stride(0), symm.ints(ranks), n_local)
            dims = (B, H, KVH, D, bs, n_loc, C, n_split)
        else:
            S_loc = k[0].shape[1]
            n_split = n_splits(B * n_local, KVH, -(-S_loc // _TILE), dev)
            head = (symm.ptrs([q[r] for r in ranks]),
                    symm.ptrs([k[r] for r in ranks]),
                    symm.ptrs([v[r] for r in ranks]),
                    symm.ptrs([cur_len[r] for r in ranks]),
                    symm.ints(ranks), n_local)
            dims = (B, H, KVH, D, S_loc, n_split)
        part = torch.empty((n_local, B, n_split, H, D + 2),
                           dtype=torch.float32, device=dev)
        out = (torch.empty((n_local, B, H, D + 2), dtype=torch.float32,
                           device=dev) if mode == PARTIAL else
               torch.empty((n_local, B, H, D), dtype=q[0].dtype,
                           device=dev))
        sym = (call.args(mesh.distinct.index(dev)) if call is not None
               else (None, None, W, 0, 0, 0, 0))
        with torch.cuda.device(dev):
            rc = fn(*head, part.data_ptr(), out.data_ptr(), *dims,
                    float(scale), -1 if window is None else int(window),
                    _DTYPES[q[0].dtype], mode, chunks, *sym,
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, name)
        for i, r in enumerate(ranks):
            outs[r] = out[i]
    return outs


def _split(raw):
    """fp32 (B, H, D + 2) partial rows -> (o, m, l)."""
    D = raw.shape[-1] - 2
    return raw[..., :D], raw[..., D], raw[..., D + 1]


def _check_window(window):
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _check_tables(name, tables, W, B):
    if len(tables) != W:
        raise ValueError(f"{name}: {len(tables)} tables for {W} ranks")
    for t in tables:
        if t.dim() != 2 or t.shape != tables[0].shape or t.shape[0] != B:
            raise ValueError(f"{name}: tables {tuple(t.shape)} do not fit "
                             f"batch {B}")
    if _all_cpu(tables):
        return
    for r, t in enumerate(tables):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tables must be int32")
        if t.stride(1) != 1 or t.stride(0) != tables[0].stride(0):
            raise ValueError(f"{name}: table rows must be contiguous with "
                             f"one row stride (a leading column slice of "
                             f"a row-major table is fine)")


# --------------------------------------------------------------- wrappers
def flash_decode_paged(q, k_pool, v_pool, cur_len, tables, scale,
                       window: int | None = None):
    """Paged decode attention on one rank. q: (B, H, D); k_pool/v_pool:
    (n_blocks, block_size, KVH, D); cur_len: (B,) int32 lengths including
    this step's token; tables: (B, C) int32 block ids (-1 = hole),
    possibly a leading ``[:, :gather_width]`` slice of a wider table.
    Returns (B, H, D) in q's dtype."""
    name = "flash_decode_paged"
    if k_pool.dim() != 4:
        raise ValueError(f"{name}: pools must be (n_blocks, bs, KVH, D), "
                         f"got {tuple(k_pool.shape)}")
    _check_common(name, [q], [k_pool], [v_pool], [cur_len], None)
    _check_tables(name, [tables], 1, q.shape[0])
    _check_window(window)
    if _all_cpu([q, k_pool, v_pool, cur_len, tables]):
        flash_decode_paged.plain_calls += 1
        return paged_decode_plain(q, k_pool, v_pool, cur_len, tables, scale,
                                  window)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    out = _launch(name, NORMAL, [q], [k_pool], [v_pool], [cur_len], scale,
                  window, tables=[tables])[0]
    flash_decode_paged.launches += 1
    return out


def _paged_ranks(name, q, k_pools, v_pools, cur_len, tables, window, mesh):
    W = _check_common(name, q, k_pools, v_pools, cur_len, mesh)
    if k_pools[0].dim() != 4:
        raise ValueError(f"{name}: pool shards must be (n_loc, bs, KVH, "
                         f"D), got {tuple(k_pools[0].shape)}")
    _check_tables(name, tables, W, q[0].shape[0])
    _check_window(window)
    return _all_cpu(q, k_pools, v_pools, cur_len, tables)


def flash_decode_paged_partial(q, k_pools, v_pools, cur_len, tables, scale,
                               window: int | None = None):
    """Each rank's unnormalised paged partial (o, m, l) over its pool
    shard (n_loc, bs, KVH, D), which holds global blocks
    [r * n_loc, (r + 1) * n_loc). Per-rank lists in and out."""
    name = "flash_decode_paged_partial"
    n_loc = k_pools[0].shape[0]
    if _paged_ranks(name, q, k_pools, v_pools, cur_len, tables, window,
                    None):
        flash_decode_paged_partial.plain_calls += 1
        return [paged_partial_plain(q[r], k_pools[r], v_pools[r],
                                    cur_len[r], tables[r], scale, window,
                                    base=r * n_loc)
                for r in range(len(k_pools))]
    raw = _launch(name, PARTIAL, q, k_pools, v_pools, cur_len, scale,
                  window, tables=tables)
    flash_decode_paged_partial.launches += len(symm.rank_groups(k_pools))
    return [_split(x) for x in raw]


def flash_decode_paged_fused(q, k_pools, v_pools, cur_len, tables, scale,
                             window: int | None = None, mesh=None):
    """Paged decode over the W ranks of ``mesh``, fused: each rank's
    partial over its pool shard is pushed to every rank and the sources
    are combined in rank order in the kernel. Per-rank lists in; per-rank
    (B, H, D) outputs in q's dtype, bit-identical across ranks."""
    name = "flash_decode_paged_fused"
    n_loc = k_pools[0].shape[0]
    if _paged_ranks(name, q, k_pools, v_pools, cur_len, tables, window,
                    mesh):
        flash_decode_paged_fused.plain_calls += 1
        return fused_plain(
            [paged_partial_plain(q[r], k_pools[r], v_pools[r], cur_len[r],
                                 tables[r], scale, window, base=r * n_loc)
             for r in range(len(k_pools))], q[0].dtype)
    out = _launch(name, FUSED, q, k_pools, v_pools, cur_len, scale, window,
                  mesh=mesh, tables=tables)
    flash_decode_paged_fused.launches += len(symm.rank_groups(k_pools))
    return out


def _strided_ranks(name, q, k_shards, v_shards, cur_len, window, mesh):
    W = _check_common(name, q, k_shards, v_shards, cur_len, mesh)
    if k_shards[0].dim() != 4:
        raise ValueError(f"{name}: shards must be (B, S_loc, KVH, D), got "
                         f"{tuple(k_shards[0].shape)}")
    if k_shards[0].shape[0] != q[0].shape[0]:
        raise ValueError(f"{name}: shard batch {k_shards[0].shape[0]} != "
                         f"q batch {q[0].shape[0]}")
    _check_window(window)
    return W, _all_cpu(q, k_shards, v_shards, cur_len)


def flash_decode_partial(q, k_shards, v_shards, cur_len, scale,
                         window: int | None = None):
    """Each rank's unnormalised partial (o, m, l) over its strided shard
    (B, S_loc, KVH, D) (local slot j holds position j * W + r). Per-rank
    lists in and out; cur_len per rank (B,) int32."""
    name = "flash_decode_partial"
    W, cpu = _strided_ranks(name, q, k_shards, v_shards, cur_len, window,
                            None)
    if cpu:
        flash_decode_partial.plain_calls += 1
        return [strided_partial_plain(q[r], k_shards[r], v_shards[r],
                                      cur_len[r], scale, window, r, W)
                for r in range(W)]
    raw = _launch(name, PARTIAL, q, k_shards, v_shards, cur_len, scale,
                  window)
    flash_decode_partial.launches += len(symm.rank_groups(k_shards))
    return [_split(x) for x in raw]


def flash_decode_fused(q, k_shards, v_shards, cur_len, scale,
                       window: int | None = None, mesh=None):
    """Decode attention over a strided cache sharded on W ranks, fused
    (Algorithm 4): partial, push to every rank, combine in rank order in
    the kernel. At W = 1 the single source is normalised in place (no
    mesh needed). Per-rank lists in; per-rank (B, H, D) outputs in q's
    dtype, bit-identical across ranks."""
    name = "flash_decode_fused"
    W, cpu = _strided_ranks(name, q, k_shards, v_shards, cur_len, window,
                            mesh)
    if cpu:
        flash_decode_fused.plain_calls += 1
        return fused_plain(
            [strided_partial_plain(q[r], k_shards[r], v_shards[r],
                                   cur_len[r], scale, window, r, W)
             for r in range(W)], q[0].dtype)
    out = _launch(name, NORMAL if W == 1 else FUSED, q, k_shards, v_shards,
                  cur_len, scale, window, mesh=mesh)
    flash_decode_fused.launches += len(symm.rank_groups(k_shards))
    return out


for _fn in (flash_decode_paged, flash_decode_paged_partial,
            flash_decode_paged_fused, flash_decode_partial,
            flash_decode_fused):
    _fn.launches = 0
    _fn.plain_calls = 0
