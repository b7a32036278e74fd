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

Values are per-rank lists (see ``core.flash_decode``). The train sites
take W = 1 too, as a list of one: a plain product (the up sites' group
in one launch), whatever the mode, as in JAX.
"""
from __future__ import annotations

from repro_torch.core import collective_matmul as cm
from repro_torch.core import flash_decode as fd
from repro_torch.distributed import context as dctx
from repro_torch.kernels.ag_gemm import ag_gemm_fused
from repro_torch.models.layers import dense, dense_group

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


def project_k_sharded(x, w):
    """The paper's Figure-3 AG+GEMM, decode row-parallel site: ``x`` per
    rank (..., K) (ranks agree; each keeps its own K/W columns), ``w``
    per rank (K, N). Returns per rank (..., N)."""
    ctx = dctx.current()
    mesh, mode = ctx.mesh, ctx.fusion_mode
    if mode == "auto":
        return [dense(xr, wr) for xr, wr in zip(x, w)]
    if mode == "pallas":
        W = mesh.size
        K = x[0].shape[-1]
        if K % W:
            raise ValueError(f"ag_gemm_fused: K={K} must divide by W={W}")
        k = K // W
        lead = x[0].shape[:-1]
        shards = [x[r].reshape(-1, K)[:, r * k:(r + 1) * k].contiguous()
                  for r in range(W)]
        cm.record("all-gather", W * cm.nbytes(shards[0]), W)
        out = ag_gemm_fused(shards, [wr.to(xr.dtype) for wr, xr in
                                     zip(w, x)], mesh)
        return [o.reshape(*lead, o.shape[-1]) for o in out]
    m = "bsp" if mode == "bsp" else "ring_bidir"
    return cm.ag_gemm_k_sharded_sm([xr for xr in x],
                                   [wr.to(xr.dtype) for wr, xr in zip(w, x)],
                                   mesh, mode=m)


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
