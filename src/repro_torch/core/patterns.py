"""Where the paper's technique plugs into the model (port of
``repro.core.patterns``): the train/prefill sites and the decode sites.

Model code calls :func:`project_up`, :func:`project_down`,
:func:`project_k_sharded` and the ``decode_attn*`` functions; they
dispatch on the ambient ``DistContext.fusion_mode``
(``distributed.context``), with the JAX package's tables.

Train/prefill (sequence parallelism between blocks; the paper's
AG+GEMM in front of the up projections, GEMM+RS behind the down ones):

* ``bsp``    -- ``bsp`` (the blocking collective, then the GEMM);
* ``ring``, ``pallas`` -- ``ring_bidir``. JAX has no Pallas kernel at
                these sites and maps ``pallas`` to the ring, and so does
                the port; the no-fallback rule of ``pallas`` holds at
                the decode sites;
* ``auto``   -- XLA's choice in JAX. The port keeps the same per-rank
                layout with plain gathers and sums and no ring (the
                ``bsp`` schedule); only the values compare;
* a sequence that does not divide by W takes JAX's fallback, a local
  product: the residual stream is then replicated (every row on every
  rank) and a down projection's partial sums are summed over the ranks.

Decode:

* ``auto``   -- attention combine ``rs_ag``; ``wo`` a local GEMM of the
                replicated input on every device;
* ``bsp``    -- blocking gather, then compute (the paper's baseline);
* ``ring``   -- attention combine ``ring``; ``wo`` ``ring_bidir``;
* ``pallas`` -- the fused in-kernel push kernels: the fused paged or
                strided flash decode and the fused AG+GEMM
                (``kernels.flash_decode``, ``kernels.ag_gemm``). It never
                falls back to ``ring``: a shape the kernels cannot take
                raises.

Decode over sharded weights (JAX's serve step on ``param_shardings``),
where activations are replicated (one tensor per distinct device) and
each rank holds its shards: a column-parallel group runs one grouped GEMM
a rank over its columns (:func:`column_shards`), gathered to every
device where the step needs the whole output (:func:`gather_columns`:
q/k/v, the Mamba2 in_proj); at the row-parallel site
(:func:`project_k_sharded` on row shards) ``auto`` sums each rank's
partial product in fp32 in rank order (:func:`row_parallel_sum`: the
local partial dot and all-reduce GSPMD makes of JAX's einsum), and
``bsp``/``ring``/``pallas`` all-gather the row shards into a transient
whole weight once per distinct device, then run the mode's AG+GEMM, as
GSPMD gathers the weight in front of JAX's ``shard_map`` (which takes it
replicated).

Values are per-rank lists (see ``core.flash_decode``). The train sites
take W = 1 too, as a list of one: a plain product (the up sites' group
in one launch), whatever the mode, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.core import collective_matmul as cm
from repro_torch.core import flash_decode as fd
from repro_torch.distributed import context as dctx
from repro_torch.distributed import fsdp
from repro_torch.kernels import symm
from repro_torch.kernels.ag_gemm import ag_gemm_fused
from repro_torch.models.layers import dense, dense_group, dense_group_ranks

_ATTN_COMBINE = {"auto": "rs_ag", "bsp": "bsp", "ring": "ring",
                 "pallas": "pallas"}
# the train/prefill sites: JAX's table; auto takes the bsp schedule
_SP_MODE = {"auto": "bsp", "bsp": "bsp", "ring": "ring_bidir",
            "pallas": "ring_bidir"}


def _sp_mode() -> str:
    return _SP_MODE[dctx.current().fusion_mode]


def project_up(x, ws, *, seq_axis_sharded: bool = True):
    """y_i[..., n] = x[..., k] @ w_i[k, n] for each site i of a group
    that shares ``x`` (wq/wk/wv, wg/wu), every w_i column(TP)-sharded:
    the paper's AG+GEMM site. ``x`` per rank (..., S/W, K), rank r's rows
    (``seq_axis_sharded``), or (..., S, K), every row (the fallback of a
    sequence that does not divide by W); ``ws`` one per-rank list (K,
    N_i/W) per site. Returns one per-rank list (..., S, N_i/W) per site.

    One rank, the fallback and the ``bsp`` schedule multiply the whole
    group in one GEMM launch a rank (``layers.dense_group``; at W = 1
    that is the single-rank block); ``ring_bidir`` runs each site's
    ring."""
    W = len(x)
    ws = [[wr.to(xr.dtype) for wr, xr in zip(w, x)] for w in ws]
    if W > 1 and seq_axis_sharded:
        for w in ws:
            cm.check_ag_gemm_m_sharded(x[0].shape[-2] * W, x[0].shape[-1],
                                       w[0].shape[0], w[0].shape[-1] * W, W)
        mode = _sp_mode()
        if mode != "bsp":
            return [cm.ag_gemm_m_sharded(x, w, mode=mode) for w in ws]
        x = cm.all_gather(x, gather_axis=x[0].dim() - 2)
    per_rank = [dense_group(xr, [w[r] for w in ws]) for r, xr in enumerate(x)]
    return [[ys[i] for ys in per_rank] for i in range(len(ws))]


def project_down(x, w):
    """y = x @ w with x column(TP)-sharded on K and w row-sharded: the
    paper's GEMM+RS site. ``x`` per rank (..., S, K/W), ``w`` per rank
    (K/W, N). Returns per rank (..., S/W, N), rank r's rows; a sequence
    that does not divide by W gets the partial products summed over the
    ranks instead, every row on every rank. One rank: one product."""
    W = len(x)
    w = [wr.to(xr.dtype) for wr, xr in zip(w, x)]
    S = x[0].shape[-2]
    if W == 1 or S % W:
        part = [dense(xr, wr) for xr, wr in zip(x, w)]
        if W == 1:
            return part
        out = []
        for xr in x:
            acc = None
            for p in part:
                p = cm.to_device(p, xr.device)
                acc = p if acc is None else acc + p
            out.append(acc)
        return out
    cm.check_gemm_rs(S, x[0].shape[-1] * W, W)
    return cm.gemm_rs(x, w, mode=_sp_mode())


def project_k_sharded(x, w, *, rows: bool = False, x_sliced: bool = False):
    """The paper's Figure-3 AG+GEMM, decode row-parallel site: ``x`` per
    rank (..., K) (ranks agree; each keeps its own K/W columns), or with
    ``x_sliced`` rank r's K/W columns alone (the MLP's hidden units of
    its column shards); ``w`` per rank (K, N), or with ``rows`` rank r's
    row block (K/W, N) of a weight the rules shard (the caller says
    which, from ``lm.split_axes``; a shape that is neither raises).
    Returns per rank (..., N).

    On row blocks, ``auto`` sums the ranks' partial products
    (:func:`row_parallel_sum`); the other modes all-gather the blocks
    into a transient (K, N) once per distinct device (recorded as an
    ``all-gather`` of the weight's bytes) and run the AG+GEMM on it."""
    ctx = dctx.current()
    mesh, mode = ctx.mesh, ctx.fusion_mode
    W = mesh.size
    if x_sliced and not rows:
        raise ValueError("project_k_sharded: a K-sliced x needs the row "
                         "blocks of w")
    K = x[0].shape[-1] * (W if x_sliced else 1)
    if w[0].shape[0] * (W if rows else 1) != K:
        raise ValueError(f"project_k_sharded: w {tuple(w[0].shape)} is not "
                         f"{'a row block' if rows else 'the whole'} of a "
                         f"({K}, N) weight over W={W}")
    if mode == "auto" and not rows:
        return [dense(xr, wr) for xr, wr in zip(x, w)]
    if K % W:
        raise ValueError(f"project_k_sharded: K={K} must divide by W={W}")
    k = K // W
    lead = x[0].shape[:-1]
    ids = symm.rank_ids(x, mesh)
    shards = x if x_sliced else [x[i][..., r * k:(r + 1) * k]
                                 for i, r in enumerate(ids)]
    if mode == "auto":
        return mesh.per_rank(row_parallel_sum(shards, w))
    if rows:
        w = mesh.per_rank(_gather_row_blocks(w, mesh))
    w = [wr.to(xr.dtype) for wr, xr in zip(w, x)]
    if mode == "pallas":
        shards = [s.reshape(-1, k).contiguous() for s in shards]
        cm.record("all-gather", W * cm.nbytes(shards[0]), W)
        out = _ag_gemm_fused(shards, w, mesh)
        return [o.reshape(*lead, o.shape[-1]) for o in out]
    m = "bsp" if mode == "bsp" else "ring_bidir"
    if symm.split(mesh):
        # every rank's shard here (one exchange) and the weight whole on
        # this process's one device: the product of the group's first
        # rank, in the schedule's order, for each of this process's
        # ranks. One process with every rank on one card hands on that
        # rank's value (Mesh.from_ranks), and a ring's per-rank sums
        # differ in their order, so every process takes it too
        cm.check_ag_gemm_k_sharded(K, w[0].shape[0], W, m)
        g0 = mesh.first - mesh.first % mesh.model
        out = cm.ag_gemm_k_sharded(symm.every_rank(shards, mesh),
                                   [w[0]] * W, mode=m, ranks=[g0])[0]
        return cm._per_rank_copies(out, len(ids))
    if not x_sliced:
        return cm.ag_gemm_k_sharded_sm(list(x), w, mesh, mode=m)
    cm.check_ag_gemm_k_sharded(K, w[0].shape[0], W, m)
    return cm.ag_gemm_k_sharded(shards, w, mode=m)


def _gather_row_blocks(w, mesh):
    """The row blocks ``w`` (per rank (K/W, N)) all-gathered over the
    ``model`` axis into a whole (K, N) once per distinct device. Blocks
    also cut over ``data`` on N (``cm.Stationary``, a data mesh's
    weights-stationary decode) are gathered over ``model`` block by
    block, never over ``data``: the (K, N/D) of each data block."""
    if not isinstance(w[0], cm.Stationary):
        return cm.all_gather_devices(w, mesh.distinct, gather_axis=0)
    blocks = [cm.all_gather_devices([t.blocks[i] for t in w],
                                    [w[0].blocks[i].device],
                                    gather_axis=0)[0]
              for i in range(len(w[0].blocks))]
    whole = cm.Stationary(blocks, w[0].dim, w[0].span)
    return [whole] * len(mesh.distinct)


def _ag_gemm_fused(shards, w, mesh):
    """The fused AG+GEMM kernel over ``mesh``'s ranks; on a weight cut
    over ``data`` on its N dim (``cm.Stationary``) one launch per data
    block g this process holds, over data group g's model ranks of the
    pod (``Mesh.group`` of the ambient ``DistContext.data``), the
    blocks' outputs joined (over processes through the weight's span;
    the ranks' outputs are one: the first's, joined once)."""
    if not isinstance(w[0], cm.Stationary):
        return ag_gemm_fused(shards, w, mesh)
    data = dctx.current().data
    D = w[0].n_blocks
    pod = data.local_groups[0] // D
    parts = []
    for i, g in enumerate(w[0].held):
        grp = data.group(pod * D + g)
        parts.append(ag_gemm_fused(
            [cm.to_device(s, d) for s, d in zip(shards, grp.devices)],
            [wr.blocks[i] for wr in w], grp))
    if w[0].span is None:
        out = [torch.cat([cm.to_device(p[r], s.device) for p in parts],
                         dim=-1) for r, s in enumerate(shards)]
    else:
        out = cm._per_rank_copies(symm.all_gather(
            [cm.to_device(p[0], shards[0].device) for p in parts],
            w[0].span, -1), len(shards))
    cm.record("all-gather", cm.nbytes(out[0]), D)
    return out


def join_groups(outs, dev):
    """Every data group's rows of a whole-batch output, joined in group
    order on ``dev``, from this process's groups' (``outs``, in
    ``Mesh.local_groups`` order) under the ambient ``DistContext.data``;
    over processes one collective over the ranks of this process's first
    model rank in every group (``Mesh.axis_span``)."""
    data = dctx.current().data
    outs = [cm.to_device(o, dev) for o in outs]
    if not data.spans or len(outs) == data.dp:
        out = torch.cat(outs, dim=0)
    else:
        span = data.axis_span(data.first, ("pod", "data"))
        out = symm.all_gather(outs, span, 0)
    cm.record("all-gather", cm.nbytes(out), data.dp)
    return out


def over_groups(fn, params, states, *inputs):
    """The batch-sharded part of a decode step over a mesh with data
    groups (the ambient ``DistContext.data``): ``fn(params, state_i,
    *rows)`` for each copy i of a state this process's groups hold
    (``Mesh.holders``: (g, device)), on group g's rows (``Mesh.rows``)
    of each whole-batch input, moved to the copy's device (``fn`` writes
    the state in place). ``params``: the view ``fn`` reads its weights
    from; where processes hold the groups, each brings its own rows, and
    ``fn`` gets the view with its weights cut over ``data`` marked so
    (:func:`_rows_apart`). Returns ``fn``'s output (a tensor or a tuple
    of them), each group's rows joined over ``data`` on the first
    input's device (:func:`join_groups`; where the batch does not
    divide, every group ran every row, and this process's first copy's
    output is every group's)."""
    data = dctx.current().data
    B, dev = inputs[0].shape[0], inputs[0].device
    if data.spans:
        params = _rows_apart(params)
    first: dict = {}
    for st, (g, d) in zip(states, data.holders):
        rows = data.rows(g, B)
        out = fn(params, st, *[cm.to_device(t[rows], d) for t in inputs])
        first.setdefault(g, out if isinstance(out, tuple) else (out,))
    outs = list(first.values())
    if B % data.dp:
        joined = tuple(cm.to_device(t, dev) for t in outs[0])
    else:
        joined = tuple(join_groups([o[j] for o in outs], dev)
                       for j in range(len(outs[0])))
    return joined if len(joined) > 1 else joined[0]


def _rows_apart(tree):
    """``tree`` (a layer's parameters: a dict or an ``fsdp.View``) with
    each weight cut over ``data`` across processes marked rows-apart
    (``cm.Stationary.rows_apart``); the tensors are its own."""
    if isinstance(tree, cm.Stationary):
        return tree.rows_apart()
    if not isinstance(tree, dict):
        return tree
    out = {k: _rows_apart(v) for k, v in tree.items()}
    return fsdp.View(out, tree.device) if isinstance(tree, fsdp.View) \
        else out


def row_parallel_sum(x, w):
    """sum_r x_r @ w_r over the ranks, as a replicated value: ``x`` per
    rank (..., K/W) (its K-slice), ``w`` per rank (K/W, N) (its row
    block); each rank's partial product (the GEMM, in ``x``'s dtype)
    summed in fp32 in rank order once per distinct device
    (``cm.all_reduce_devices``), cast back to ``x``'s dtype. Returns
    per device (..., N)."""
    mesh = dctx.current().mesh
    parts = [y[0].float() for y in dense_group_ranks(
        [xr.contiguous() for xr in x], [[wr] for wr in w])]
    return [t.to(x[0].dtype)
            for t in cm.all_reduce_devices(parts, mesh.distinct)]


def column_shards(x, ws):
    """The decode column-parallel products over per-rank weights: ``x``
    per distinct device (..., K), replicated; ``ws`` one per-rank list
    per site of a group that shares ``x`` (wq/wk/wv, wg/wu), rank r's
    (K, N_i/W) column block (or the whole (K, N_i) where the rules
    replicate it). One grouped GEMM launch a rank. Returns one per-rank
    list (..., N_i/W) per site."""
    mesh = dctx.current().mesh
    n = len(mesh.devices)
    ys = dense_group_ranks(mesh.per_rank(x),
                           [[w[r] for w in ws] for r in range(n)])
    return [[y[i] for y in ys] for i in range(len(ws))]


def gather_columns(x, ws, split):
    """:func:`column_shards` with each site's output made whole on every
    distinct device: ``split`` says per site whether its weight is a
    column block (all-gathered, ``cm.all_gather_devices``) or whole
    (taken from the first rank of each device). A group whole at every
    site runs once per device. Returns one per-device list (..., N_i)
    per site."""
    mesh = dctx.current().mesh
    if not any(split):
        ys = [dense_group(xd, [w[r] for w in ws])
              for xd, r in zip(x, mesh.leaders)]
        return [[y[i] for y in ys] for i in range(len(ws))]
    ys = column_shards(x, ws)
    if symm.split(mesh) and all(split) and len(ws) > 1:
        return _gather_sites(ys, mesh)
    return [cm.all_gather_devices(y, mesh.distinct, gather_axis=-1) if s
            else mesh.from_ranks(y) for y, s in zip(ys, split)]


def _gather_sites(ys, mesh):
    """Each site's column blocks (``ys``: one per-rank list per site)
    joined in rank order on this process's device where processes split
    the model axis: every site's blocks in ONE exchange (a cross-process
    call costs a switch between contexts on a shared card), then cut
    apart; the same bytes as a gather per site."""
    W = mesh.size
    n = [y[0].shape[-1] for y in ys]
    full = symm.every_rank([torch.cat(cols, dim=-1) for cols in zip(*ys)],
                           mesh)
    out, at = [], 0
    for y, ni in zip(ys, n):
        cm.record("all-gather", W * cm.nbytes(y[0]), W)
        out.append([torch.cat([f[..., at:at + ni] for f in full], dim=-1)])
        at += ni
    return out


def decode_attn_fused(q, k_new, v_new, k_cache, v_cache, cur_len, *, scale,
                      window: int | None = None,
                      rolling_len: int | None = None, active=None):
    """Strided contiguous cache: ownership write + attention + combine
    over the mesh (``core.flash_decode.decode_attention_fused``)."""
    ctx = dctx.current()
    return fd.decode_attention_fused(
        q, k_new, v_new, k_cache, v_cache, cur_len, scale=scale,
        mode=_ATTN_COMBINE[ctx.fusion_mode], window=window,
        rolling_len=rolling_len, active=active, mesh=ctx.mesh)


def decode_attn_paged(q, k_new, v_new, k_pool, v_pool, cur_len,
                      block_tables, *, scale, window: int | None = None,
                      active=None, bounded: bool = True):
    """Paged pool: block-table write into the owning rank's shard +
    partial attention over each shard + combine
    (``core.flash_decode.decode_paged_attention_fused``)."""
    ctx = dctx.current()
    return fd.decode_paged_attention_fused(
        q, k_new, v_new, k_pool, v_pool, cur_len, block_tables, scale=scale,
        mode=_ATTN_COMBINE[ctx.fusion_mode], window=window, active=active,
        bounded=bounded, mesh=ctx.mesh)
