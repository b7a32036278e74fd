"""The paper's §4.1 collective matmuls over W ranks (port of
``repro.core.collective_matmul``). Three layouts, as in JAX:

* ``ag_gemm_k_sharded`` -- the paper's Figure-3 site: A (M, K/W) per
  rank, B (K, N) replicated, C = sum_s A_s @ B_s on every rank. The
  decode row-parallel projection (``wo``).
* ``ag_gemm_m_sharded`` -- A (..., M/W, K) sequence-sharded rows, B
  (K, N/W) column-parallel; gathers rows while computing. The up/qkv
  projections of prefill and training under sequence parallelism.
* ``gemm_rs``           -- A (..., M, K/W) @ B (K/W, N) partial sums
  reduce-scattered over M. The down/o projections under sequence
  parallelism.

Modes, as in the JAX package (``fused`` lives in ``kernels.ag_gemm``):

* ``bsp``        the explicit collective, then the GEMM (the paper's
                 baseline);
* ``ring``       W steps: multiply the block held, pass it (or the
                 partial sum) to the right neighbour;
* ``ring_bidir`` two halves travel the ring in opposite directions.

Values are per-rank lists. Per-rank GEMMs go through the GEMM kernel
(``kernels.matmul``; its plain version for CPU tensors), so autograd
records every step of a ring (the kernel's own backward); rank-to-rank
moves are copies onto the receiving rank's device.

While a dry run records (:func:`recording`; ``launch.dryrun``), every
collective here and in ``core.flash_decode`` reports itself as JAX's HLO
names it (``all-gather``, ``reduce-scatter``, ``all-reduce``,
``collective-permute``: one per ring step), with its size and group; a
collective that autograd records reports its backward's dual too
(all-gather and reduce-scatter swap). With no recorder installed a
report returns at once.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import capturing
from repro_torch.kernels.matmul import matmul

# ------------------------------------------------------------- recording
_RECORDER = None
_DUAL = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
         "all-reduce": "all-reduce",
         "collective-permute": "collective-permute"}


@contextlib.contextmanager
def recording(sink):
    """Report every collective to ``sink(op, size, group)`` inside the
    block (``size``: bytes of the op's whole operand, JAX's R). Refused
    under a CUDA graph capture: a dry run traces on the CPU."""
    global _RECORDER
    if capturing():
        raise RuntimeError("collective recording under a CUDA graph capture")
    prev, _RECORDER = _RECORDER, sink
    try:
        yield sink
    finally:
        _RECORDER = prev


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def record(op: str, size: int, group: int, n: int = 1, out=None):
    """Report ``n`` collectives ``op`` of ``size`` bytes over ``group``
    ranks to the installed recorder (nothing without one, or at one
    rank); where autograd records ``out``, its backward reports the dual
    op as the gradient passes."""
    sink = _RECORDER
    if sink is None or group < 2:
        return
    for _ in range(n):
        sink(op, size, group)
    if out is not None and out.requires_grad:
        dual = _DUAL[op]

        def backward_hook(grad):
            for _ in range(n):
                sink(dual, size, group)
        out.register_hook(backward_hook)


def _mm(a, b):
    """(..., k) @ (k, N) through the GEMM kernel."""
    lead = a.shape[:-1]
    return matmul(a.reshape(-1, a.shape[-1]).contiguous(), b).reshape(
        *lead, b.shape[1])


def to_device(x, dev):
    """``x`` on ``dev``: a copy when it lies elsewhere."""
    return x.to(dev, copy=x.device != dev)


def ag_gemm_k_sharded(a_shards, b, *, mode: str = "ring"):
    """C = concat_K(A) @ B with A K-sharded. a_shards: per rank
    (..., M, K/W); b: per rank (K, N). Returns per rank (..., M, N)."""
    W = len(a_shards)
    k = a_shards[0].shape[-1]
    devs = [x.device for x in a_shards]

    def move(x, r):
        return to_device(x, devs[r])

    if mode == "bsp":
        record("all-gather", W * nbytes(a_shards[0]), W, out=a_shards[0])
        out = []
        for r in range(W):
            a_full = torch.empty((*a_shards[r].shape[:-1], W * k),
                                 dtype=a_shards[r].dtype, device=devs[r])
            for s in range(W):
                a_full[..., s * k:(s + 1) * k].copy_(a_shards[s])
            out.append(_mm(a_full, b[r]))
        return out

    if mode == "ring":
        record("collective-permute", nbytes(a_shards[0]), W, n=W - 1,
               out=a_shards[0])
        cur, acc = list(a_shards), [None] * W
        for t in range(W):
            for r in range(W):
                s = (r - t) % W          # shard held by rank r at step t
                part = _mm(cur[r], b[r][s * k:(s + 1) * k])
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur = [move(cur[(r - 1) % W], r) for r in range(W)]
        return acc

    if mode == "ring_bidir":
        h = k // 2
        cur_r = [a[..., :h].contiguous() for a in a_shards]
        cur_l = [a[..., h:].contiguous() for a in a_shards]
        for half in (cur_r[0], cur_l[0]):
            record("collective-permute", nbytes(half), W, n=W - 1, out=half)
        acc = [None] * W
        for t in range(W):
            for r in range(W):
                s_r, s_l = (r - t) % W, (r + t) % W
                part = (_mm(cur_r[r], b[r][s_r * k:s_r * k + h])
                        + _mm(cur_l[r], b[r][s_l * k + h:(s_l + 1) * k]))
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur_r = [move(cur_r[(r - 1) % W], r) for r in range(W)]
                cur_l = [move(cur_l[(r + 1) % W], r) for r in range(W)]
        return acc

    raise ValueError(f"unknown mode {mode!r}")


def ag_gemm_m_sharded(a_shards, b, *, mode: str = "ring"):
    """C = all_gather_M(A) @ B_local. a_shards: per rank (..., M/W, K)
    (rank r holds row block r); b: per rank (K, N/W). Returns per rank
    (..., M, N/W): every row, the rank's column block."""
    W = len(a_shards)
    devs = [x.device for x in a_shards]
    mdim = a_shards[0].dim() - 2
    m = a_shards[0].shape[mdim]

    if mode == "bsp":
        record("all-gather", W * nbytes(a_shards[0]), W, out=a_shards[0])
        return [_mm(torch.cat([to_device(a, devs[r]) for a in a_shards],
                              dim=mdim), b[r]) for r in range(W)]

    if mode == "ring":
        record("collective-permute", nbytes(a_shards[0]), W, n=W - 1,
               out=a_shards[0])
        cur = list(a_shards)
        blocks = [[None] * W for _ in range(W)]
        for t in range(W):
            for r in range(W):
                blocks[r][(r - t) % W] = _mm(cur[r], b[r])
            if t < W - 1:
                cur = [to_device(cur[(r - 1) % W], devs[r]) for r in range(W)]
        return [torch.cat(bl, dim=mdim) for bl in blocks]

    if mode == "ring_bidir":
        h = m // 2
        cur_r = [a.narrow(mdim, 0, h) for a in a_shards]
        cur_l = [a.narrow(mdim, h, m - h) for a in a_shards]
        for half in (cur_r[0], cur_l[0]):
            record("collective-permute", nbytes(half), W, n=W - 1, out=half)
        top = [[None] * W for _ in range(W)]     # rows [s*m, s*m + h)
        bot = [[None] * W for _ in range(W)]     # rows [s*m + h, (s+1)*m)
        for t in range(W):
            for r in range(W):
                top[r][(r - t) % W] = _mm(cur_r[r], b[r])
                bot[r][(r + t) % W] = _mm(cur_l[r], b[r])
            if t < W - 1:
                cur_r = [to_device(cur_r[(r - 1) % W], devs[r])
                         for r in range(W)]
                cur_l = [to_device(cur_l[(r + 1) % W], devs[r])
                         for r in range(W)]
        return [torch.cat([x for s in range(W) for x in (top[r][s],
                                                         bot[r][s])],
                          dim=mdim) for r in range(W)]

    raise ValueError(f"unknown mode {mode!r}")


def gemm_rs(a, b, *, mode: str = "ring"):
    """(sum over ranks of A_r @ B_r) reduce-scattered over M. a: per rank
    (..., M, K/W); b: per rank (K/W, N). Returns per rank (..., M/W, N),
    rank r's row block."""
    W = len(a)
    devs = [x.device for x in a]
    mdim = a[0].dim() - 2
    m = a[0].shape[mdim] // W

    def a_block(r, s):
        return a[r].narrow(mdim, s * m, m)

    if mode == "bsp":
        partial = [_mm(a[r], b[r]) for r in range(W)]
        record("reduce-scatter", nbytes(partial[0]), W, out=partial[0])
        out = []
        for r in range(W):
            acc = None
            for p in partial:
                blk = to_device(p.narrow(mdim, r * m, m), devs[r])
                acc = blk if acc is None else acc + blk
            out.append(acc)
        return out

    if mode == "ring":
        acc = None
        for t in range(W):
            part = [_mm(a_block(r, (r - t - 1) % W), b[r]) for r in range(W)]
            if acc is not None:
                record("collective-permute", nbytes(acc[0]), W, out=acc[0])
            acc = part if acc is None else [
                to_device(acc[(r - 1) % W], devs[r]) + part[r]
                for r in range(W)]
        return acc                  # rank r: block r, fully reduced

    if mode == "ring_bidir":
        n = b[0].shape[-1]
        b_r = [x[:, :n // 2].contiguous() for x in b]
        b_l = [x[:, n // 2:].contiguous() for x in b]
        acc_r = acc_l = None
        for t in range(W):
            pr = [_mm(a_block(r, (r - t - 1) % W), b_r[r]) for r in range(W)]
            pl = [_mm(a_block(r, (r + t + 1) % W), b_l[r]) for r in range(W)]
            if acc_r is None:
                acc_r, acc_l = pr, pl
            else:
                for blk in (acc_r[0], acc_l[0]):
                    record("collective-permute", nbytes(blk), W, out=blk)
                acc_r = [to_device(acc_r[(r - 1) % W], devs[r]) + pr[r]
                         for r in range(W)]
                acc_l = [to_device(acc_l[(r + 1) % W], devs[r]) + pl[r]
                         for r in range(W)]
        return [torch.cat([x, y], dim=-1) for x, y in zip(acc_r, acc_l)]

    raise ValueError(f"unknown mode {mode!r}")


def all_gather(x, *, gather_axis: int = 0):
    """The plain all-gather (every rank copies every block at once): x
    per rank, block r of the gathered dim; returns per rank the whole
    tensor."""
    record("all-gather", nbytes(*x), len(x), out=x[0])
    return [torch.cat([to_device(t, d.device) for t in x], dim=gather_axis)
            for d in x]


def all_reduce(x):
    """The plain all-reduce: every rank sums every rank's tensor, in rank
    order, so every rank's sum is the same (x per rank, one shape)."""
    record("all-reduce", nbytes(x[0]), len(x), out=x[0])
    out = []
    for d in x:
        acc = None
        for t in x:
            t = to_device(t, d.device)
            acc = t if acc is None else acc + t
        out.append(acc)
    return out


class _ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter`'s sums, with its gradient: every rank's
    part receives the all-gather of the output blocks' gradients."""

    @staticmethod
    def forward(ctx, axis, *parts):
        W = len(parts)
        m = parts[0].shape[axis] // W
        ctx.axis = axis
        out = []
        for r, d in enumerate(p.device for p in parts):
            acc = None
            for p in parts:                       # rank order
                blk = to_device(p.narrow(axis, r * m, m), d).float()
                acc = blk if acc is None else acc + blk
            out.append(acc)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_gather([g.contiguous() for g in grads],
                                  gather_axis=ctx.axis))


def reduce_scatter(parts, *, scatter_axis: int):
    """The plain reduce-scatter of per-rank partial tensors (one shape):
    rank r receives block r of ``scatter_axis`` summed over every rank's
    part in fp32, in rank order, so the sums do not depend on the
    schedule. Its gradient is the all-gather of the blocks' gradients.
    The MoE layer's combine over ranks (``models.moe``), which no GEMM
    carries."""
    W = len(parts)
    _check(parts[0].shape[scatter_axis] % W == 0,
           f"reduce_scatter: dim {scatter_axis} of {tuple(parts[0].shape)} "
           f"must divide by W={W}")
    axis = scatter_axis % parts[0].dim()
    # its backward is all_gather, which reports itself
    record("reduce-scatter", nbytes(parts[0]), W)
    return list(_ReduceScatter.apply(axis, *parts))


def all_gather_ring(x, *, gather_axis: int = 0):
    """The standalone ring all-gather (the paper's §4.2.3): x per rank,
    block r of the gathered dim; returns per rank the whole tensor."""
    W = len(x)
    devs = [t.device for t in x]
    record("collective-permute", nbytes(x[0]), W, n=W - 1, out=x[0])
    blocks = [[None] * W for _ in range(W)]
    cur = list(x)
    for t in range(W):
        for r in range(W):
            blocks[r][(r - t) % W] = cur[r]
        if t < W - 1:
            cur = [to_device(cur[(r - 1) % W], devs[r]) for r in range(W)]
    return [torch.cat(bl, dim=gather_axis) for bl in blocks]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"collective_matmul: {msg}")


def ag_gemm_k_sharded_sm(a, b, mesh, *, axis="model", mode="ring"):
    """a: (..., M, K) with K sharded over the mesh's ranks -- one tensor
    per rank (each rank keeps its own K/W columns, as ``shard_map`` does
    with a replicated input) or one tensor for every rank; b: (K, N), one
    per rank or one for all. Returns per rank (..., M, N)."""
    W = mesh.size
    a_r = a if isinstance(a, (list, tuple)) else [a] * W
    b_r = b if isinstance(b, (list, tuple)) else [b] * W
    K = a_r[0].shape[-1]
    _check(K % W == 0,
           f"ag_gemm_k_sharded: K={K} must divide by the '{axis}' axis "
           f"size W={W} (A is K-sharded; a ragged shard would silently "
           f"drop columns)")
    _check(b_r[0].shape[0] == K,
           f"ag_gemm_k_sharded: A K dim {K} != B K dim {b_r[0].shape[0]}")
    _check(mode != "ring_bidir" or (K // W) % 2 == 0,
           f"ag_gemm_k_sharded: ring_bidir splits the local K shard "
           f"K/W={K // W} in half; it must be even — odd shards "
           f"mis-slice B's row blocks and return silently WRONG results "
           f"(measured max err ~5 on a unit test, not a rounding issue)")
    k = K // W
    shards = [a_r[r][..., r * k:(r + 1) * k].to(mesh.devices[r])
              for r in range(W)]
    return ag_gemm_k_sharded(shards, [x.to(mesh.devices[r]) for r, x in
                                      enumerate(b_r)], mode=mode)


def check_ag_gemm_m_sharded(M: int, K: int, Kb: int, N: int, W: int,
                            axis: str = "model"):
    """JAX's shape checks of ``ag_gemm_m_sharded_sm`` on global sizes."""
    _check(M % W == 0,
           f"ag_gemm_m_sharded: M={M} must divide by the '{axis}' axis "
           f"size W={W} (A is M/row-sharded)")
    _check(Kb == K,
           f"ag_gemm_m_sharded: A K dim {K} != B K dim {Kb}")
    _check(N % W == 0,
           f"ag_gemm_m_sharded: N={N} must divide by W={W} "
           f"(B is N/column-sharded)")


def check_gemm_rs(M: int, K: int, W: int, axis: str = "model"):
    """JAX's shape checks of ``gemm_rs_sm`` on global sizes."""
    _check(M % W == 0,
           f"gemm_rs: M={M} must divide by the '{axis}' axis size W={W} "
           f"— the ring reduce-scatter hands out M/W-row blocks and a "
           f"ragged M would silently DROP the trailing {M % W} row(s)")
    _check(K % W == 0,
           f"gemm_rs: K={K} must divide by W={W} (A and B are K-sharded)")


def _per_rank(x, mesh):
    xs = x if isinstance(x, (list, tuple)) else [x] * mesh.size
    return [t.to(d) for t, d in zip(xs, mesh.devices)]


def ag_gemm_m_sharded_sm(a, b, mesh, *, axis="model", mode="ring"):
    """a: (..., M, K) with M sharded over the mesh's ranks; b: (K, N)
    with N sharded -- each one tensor for every rank or one per rank
    (each rank keeps its own block, as ``shard_map`` does with a
    replicated input). Returns per rank (..., M, N/W), the rank's column
    block."""
    W = mesh.size
    a_r, b_r = _per_rank(a, mesh), _per_rank(b, mesh)
    M, K = a_r[0].shape[-2], a_r[0].shape[-1]
    N = b_r[0].shape[-1]
    check_ag_gemm_m_sharded(M, K, b_r[0].shape[0], N, W, axis)
    m, n = M // W, N // W
    return ag_gemm_m_sharded(
        [x.narrow(-2, r * m, m) for r, x in enumerate(a_r)],
        [x[:, r * n:(r + 1) * n].contiguous() for r, x in enumerate(b_r)],
        mode=mode)


def gemm_rs_sm(a, b, mesh, *, axis="model", mode="ring"):
    """a: (..., M, K) with K sharded; b: (K, N) with K sharded -- each one
    tensor for every rank or one per rank. Returns per rank (..., M/W,
    N), the rank's row block."""
    W = mesh.size
    a_r, b_r = _per_rank(a, mesh), _per_rank(b, mesh)
    M, K = a_r[0].shape[-2], a_r[0].shape[-1]
    check_gemm_rs(M, K, W, axis)
    k = K // W
    return gemm_rs([x[..., r * k:(r + 1) * k] for r, x in enumerate(a_r)],
                   [x[r * k:(r + 1) * k].contiguous()
                    for r, x in enumerate(b_r)], mode=mode)
