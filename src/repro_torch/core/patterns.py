"""Where the paper's technique plugs into the decode step (port of the
decode half of ``repro.core.patterns``).

Model code calls :func:`project_k_sharded` and the ``decode_attn*``
functions; they dispatch on the ambient ``DistContext.fusion_mode``
(``distributed.context``), with the JAX package's tables:

* ``auto``   -- attention combine ``rs_ag``; ``wo`` a local GEMM of the
                replicated input on every device;
* ``bsp``    -- blocking gather, then compute (the paper's baseline);
* ``ring``   -- attention combine ``ring``; ``wo`` ``ring_bidir``;
* ``pallas`` -- the fused in-kernel push kernels: the fused paged or
                strided flash decode and the fused AG+GEMM
                (``kernels.flash_decode``, ``kernels.ag_gemm``). It never
                falls back to ``ring``: a shape the kernels cannot take
                raises.

Values are per-rank lists (see ``core.flash_decode``); at W = 1 the
callers keep to the single-rank path.
"""
from __future__ import annotations

from repro_torch.core import collective_matmul as cm
from repro_torch.core import flash_decode as fd
from repro_torch.distributed import context as dctx
from repro_torch.kernels.ag_gemm import ag_gemm_fused
from repro_torch.models.layers import dense

_ATTN_COMBINE = {"auto": "rs_ag", "bsp": "bsp", "ring": "ring",
                 "pallas": "pallas"}


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
