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
moves are copies onto the receiving rank's device. Where other processes
hold ranks of the ambient mesh (``Mesh.spans``), a per-rank list holds
this process's ranks, and the plain gathers and sums
(:func:`all_gather`, :func:`all_gather_devices`, :func:`all_reduce`,
:func:`all_reduce_devices`) take the other ranks' blocks through
``kernels.symm`` (on the card the ``symm_exchange`` kernel, on the CPU
the gloo link), in rank order, so every value is bit-identical to the
one-process run.

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
from repro_torch.distributed import context as dctx
from repro_torch.kernels import symm
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
    """(..., k) @ (k, N) through the GEMM kernel (a :class:`Stationary`
    ``b`` block by block)."""
    if isinstance(b, Stationary):
        return stationary(lambda x, bs: [_mm(x, bs[0])], a, [b], 0)[0]
    lead = a.shape[:-1]
    return matmul(a.reshape(-1, a.shape[-1]).contiguous(), b).reshape(
        *lead, b.shape[1])


def to_device(x, dev):
    """``x`` on ``dev``: a copy when it lies elsewhere."""
    return x.to(dev, copy=x.device != dev)


# ------------------------------------------------- weights-stationary data
class Stationary:
    """One weight's D ``data`` blocks as the decode step reads them over a
    (data, model) mesh: ``blocks[i]`` is block ``held[i]`` of dim
    ``dim`` (the weight's ``embed`` or ``in_vocab`` dim, the FSDP
    shards), on the device of the rank that holds it. JAX's decode never
    gathers these (``repro/models/lm.py``, weights-stationary decode):
    every product becomes a local partial dot per block plus a small sum
    or join of its (B, 1, out) outputs over ``data`` (:func:`stationary`).
    In one process ``blocks`` holds every block; where other processes
    hold some (the data groups over processes), ``span`` is the mesh of
    the D ranks that hold block 0 .. D - 1 (``Mesh.span``: one model
    rank's ``data`` peers), ``blocks`` its local members' blocks, and
    the sums and joins cross processes through it (``kernels.symm``).
    ``apart``: each process of the span brings rows of its own to the
    products (:meth:`rows_apart`), not the same rows.

    It reads like the weight: ``shape`` is the whole one, a cast casts
    every block, an int or a slice indexes every block (a stacked
    layer's layer, a row range), an index tensor gathers rows
    (:meth:`__getitem__`). It never moves: ``to(device)`` returns it as
    it is, and the products move the activations to the blocks."""

    __slots__ = ("blocks", "dim", "span", "apart")

    def __init__(self, blocks: list, dim: int, span=None,
                 apart: bool = False):
        self.blocks, self.dim, self.span = list(blocks), dim, span
        self.apart = apart

    @property
    def n_blocks(self) -> int:
        """D: every block, here or in other processes."""
        return len(self.blocks) if self.span is None else self.span.size

    @property
    def held(self) -> range:
        """The indices of the blocks ``blocks`` holds."""
        return range(len(self.blocks)) if self.span is None \
            else self.span.local

    @property
    def shape(self) -> torch.Size:
        s = list(self.blocks[0].shape)
        s[self.dim] *= self.n_blocks
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def _like(self, blocks, dim):
        return Stationary(blocks, dim, self.span, self.apart)

    def rows_apart(self) -> "Stationary":
        """This weight where each process of its span brings rows of its
        own to the products (``patterns.over_groups`` over processes:
        each runs its data groups' rows), which :func:`stationary_ranks`
        then takes :func:`_stationary_rows`' way; itself in one
        process."""
        if self.span is None:
            return self
        return Stationary(self.blocks, self.dim, self.span, True)

    def to(self, *args, **kwargs):
        dt = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dt is None or dt == self.dtype:
            return self
        return self._like([b.to(dt) for b in self.blocks], self.dim)

    def float(self):
        return self.to(torch.float32)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self._like([b[idx] for b in self.blocks], self.dim - 1)
        if isinstance(idx, slice):
            if self.dim == 0:
                raise ValueError("a row range of a weight cut over data "
                                 "on its rows")
            return self._like([b[idx] for b in self.blocks], self.dim)
        return self._gather_rows(idx)

    def _gather_rows(self, ids):
        """``weight[ids]`` (an embedding lookup) on ``ids``' device: rows
        cut over ``data``, each block's masked gather (zeros for rows
        it does not hold) summed in block order, JAX's masked gather and
        psum; columns cut, the blocks' gathers joined."""
        dev = ids.device
        D = self.n_blocks
        if self.dim == 0:
            n = self.blocks[0].shape[0]
            parts = []
            for g, b in zip(self.held, self.blocks):
                i = to_device(ids, b.device) - g * n
                own = ((i >= 0) & (i < n)).reshape(*i.shape,
                                                   *(1,) * (b.dim() - 1))
                parts.append(to_device(torch.where(
                    own, b[i.clamp(0, n - 1)], 0), dev))
            out = over_data(parts, self.span, "sum")
            record("all-reduce", nbytes(out), D)
            return out
        out = over_data([to_device(b[to_device(ids, b.device)], dev)
                         for b in self.blocks], self.span, "join")
        record("all-gather", nbytes(out), D)
        return out


def over_data(parts, span, op: str):
    """Every data block's ``parts`` (this process's, on one device, one
    shape) combined in block order: ``"sum"`` adds them (``acc + x``),
    ``"join"`` joins them along the last dim. ``span``: the mesh of the
    blocks' ranks where other processes hold some (``Stationary.span``;
    the collective crosses processes there, ``kernels.symm``), else
    None (``parts`` is every block)."""
    if span is not None:
        return (symm.all_reduce(parts, span) if op == "sum"
                else symm.all_gather(parts, span, -1))
    if op == "join":
        return torch.cat(parts, dim=-1)
    acc = None
    for y in parts:
        acc = y if acc is None else acc + y
    return acc


def stationary(prod, x, ws, kdim: int):
    """The weights-stationary products of ``x`` with the weights ``ws``
    (the sites of a group that shares ``x``), each a :class:`Stationary`
    cut over ``data`` the same way: ``prod(x_g, [block g of each
    weight])`` runs on each held block's device (``x`` moved there), the
    one helper every decode site's product goes through on a data mesh.
    ``kdim`` is the weights' contracted dim: where ``data`` cuts it, x's
    columns of block g go to block g and the D partial outputs are
    summed in fp32 in block (rank) order, then cast back (an all-reduce
    over ``data``); where it cuts the output dim, each block's outputs
    are joined along the last dim (an all-gather). Over processes
    :func:`stationary_ranks` of one rank. Returns one output per weight,
    on ``x``'s device."""
    w0 = ws[0]
    if w0.span is not None:
        return stationary_ranks(prod, [x], [ws], kdim)[0]
    _one_cut(ws)
    kcut = w0.dim == kdim
    k = w0.blocks[0].shape[kdim] if kcut else None
    parts = []
    for g, b in enumerate(w0.blocks):
        xg = x[..., g * k:(g + 1) * k].contiguous() if kcut else x
        ys = prod(to_device(xg, b.device), [w.blocks[g] for w in ws])
        parts.append([to_device(y, x.device) for y in ys])
    return [_finish(over_data([y.float() for y in ys] if kcut else list(ys),
                              None, "sum" if kcut else "join"),
                    ys[0], kcut, w0.n_blocks)
            for ys in zip(*parts)]


def stationary_ranks(prod, xs, wss, kdim: int):
    """:func:`stationary` for each of this process's model ranks (``xs[r]``
    with its weights ``wss[r]``). Where their blocks cross processes,
    every rank's sums or joins go in one collective over all their
    spans' ranks (a rank's span alone, else the ambient
    ``DistContext.data``'s ``Mesh.span`` of them: the ranks' spans share
    their processes, a process's members a block), each rank's outputs
    combined in block order as :func:`stationary` combines them, bit for
    bit; weights marked :meth:`Stationary.rows_apart` go
    :func:`_stationary_rows`' way."""
    w0 = wss[0][0]
    if w0.span is None:
        return [stationary(prod, x, ws, kdim) for x, ws in zip(xs, wss)]
    for ws in wss:
        _one_cut(ws)
    D, n = w0.n_blocks, len(xs)
    kcut = w0.dim == kdim
    k = w0.blocks[0].shape[kdim] if kcut else None
    if w0.apart:
        return [_stationary_rows(prod, x, ws, kcut, k)
                for x, ws in zip(xs, wss)]
    span = w0.span if n == 1 else dctx.current().data.span(sorted(
        r for ws in wss for r in ws[0].span.ranks))
    sides, first = [], []
    for i, g in enumerate(w0.held):
        for x, ws in zip(xs, wss):
            xg = x[..., g * k:(g + 1) * k].contiguous() if kcut else x
            ys = [to_device(y, x.device) for y in prod(
                to_device(xg, ws[0].blocks[i].device),
                [w.blocks[i] for w in ws])]
            sides.append(_side(ys, kcut))
            if i == 0:
                first.append(ys)
    every = symm.every_rank(sides, span)          # block e of rank r: e n + r
    out = []
    for r in range(n):
        mine = [every[e * n + r] for e in range(D)]
        out.append(_outputs([over_data(mine, None, "sum")] if kcut
                            else mine, first[r], kcut, D))
    return out


def _one_cut(ws):
    """Raise unless the weights of one product group are cut over
    ``data`` alike."""
    w0 = ws[0]
    if any(not isinstance(w, Stationary) or w.dim != w0.dim
           or len(w.blocks) != len(w0.blocks) for w in ws):
        raise ValueError("weights of one product group cut over data "
                         "differently")


def _side(ys, kcut: bool):
    """A group's outputs of one block side by side (fp32 to be summed)."""
    return torch.cat([y.float() if kcut else y for y in ys], dim=-1)


def _outputs(every, ys0, kcut: bool, D: int) -> list:
    """The group's outputs (shaped and typed as ``ys0``) from ``every``,
    pieces that hold them side by side: each output's columns of the
    pieces joined (the blocks' outputs, or their sum: one piece)."""
    out, at = [], 0
    for y0 in ys0:
        n = y0.shape[-1]
        out.append(_finish(torch.cat([e[..., at:at + n] for e in every],
                                     dim=-1), y0, kcut, D))
        at += n
    return out


def _finish(y, y0, kcut: bool, D: int):
    """A weights-stationary output ``y``: cast back to ``y0``'s dtype
    where ``data`` cuts K (the fp32 sum), recorded as its collective."""
    if kcut:
        y = y.to(y0.dtype)
    record("all-reduce" if kcut else "all-gather", nbytes(y), D)
    return y


def _stationary_rows(prod, x, ws, kcut: bool, k):
    """:func:`stationary` where the processes of the weights' span bring
    different rows ``x`` (:meth:`Stationary.rows_apart`): every
    process's rows gathered (one exchange), each block held here
    multiplied with each process's rows (the products of one process's
    group, shape for shape), the partials exchanged, and this process's
    rows' D partials summed in fp32 in block order, or joined."""
    w0, span = ws[0], ws[0].span
    G = len(span.local)
    me = span.peers.index(span.procs.rank)
    xs = symm.every_rank([x] * G, span)[::G]
    sides = []
    for i, g in enumerate(w0.held):
        per = []
        for xq in xs:
            xg = xq[..., g * k:(g + 1) * k].contiguous() if kcut else xq
            ys = [to_device(y, x.device) for y in prod(
                to_device(xg, w0.blocks[i].device),
                [w.blocks[i] for w in ws])]
            per.append(_side(ys, kcut))
        sides.append(torch.stack(per))
    mine = [e[me] for e in symm.every_rank(sides, span)]
    return _outputs([over_data(mine, None, "sum")] if kcut else mine, ys,
                    kcut, w0.n_blocks)


def ag_gemm_k_sharded(a_shards, b, *, mode: str = "ring", ranks=None):
    """C = concat_K(A) @ B with A K-sharded. a_shards: per rank
    (..., M, K/W); b: per rank (K, N). Returns per rank (..., M, N);
    with ``ranks`` only those ranks' outputs (the ranks of this process
    where processes split the model axis: ``a_shards`` then holds every
    rank's shard, gathered), each the same sum in the same order."""
    W = len(a_shards)
    k = a_shards[0].shape[-1]
    devs = [x.device for x in a_shards]

    def move(x, r):
        return to_device(x, devs[r])

    rs = range(W) if ranks is None else ranks

    if mode == "bsp":
        record("all-gather", W * nbytes(a_shards[0]), W, out=a_shards[0])
        out = []
        for r in rs:
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
            for r in rs:
                s = (r - t) % W          # shard held by rank r at step t
                part = _mm(cur[r], b[r][s * k:(s + 1) * k])
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur = [move(cur[(r - 1) % W], r) for r in range(W)]
        return [acc[r] for r in rs]

    if mode == "ring_bidir":
        h = k // 2
        cur_r = [a[..., :h].contiguous() for a in a_shards]
        cur_l = [a[..., h:].contiguous() for a in a_shards]
        for half in (cur_r[0], cur_l[0]):
            record("collective-permute", nbytes(half), W, n=W - 1, out=half)
        acc = [None] * W
        for t in range(W):
            for r in rs:
                s_r, s_l = (r - t) % W, (r + t) % W
                part = (_mm(cur_r[r], b[r][s_r * k:s_r * k + h])
                        + _mm(cur_l[r], b[r][s_l * k + h:(s_l + 1) * k]))
                acc[r] = part if acc[r] is None else acc[r] + part
            if t < W - 1:
                cur_r = [move(cur_r[(r - 1) % W], r) for r in range(W)]
                cur_l = [move(cur_l[(r + 1) % W], r) for r in range(W)]
        return [acc[r] for r in rs]

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


def _over_processes(x):
    """The ambient mesh where other processes hold ranks of it and ``x``
    holds this process's ranks' entries, else None."""
    mesh = dctx.current().mesh
    return mesh if symm.split(mesh) and len(x) == len(mesh.local) else None


def _per_rank_copies(t, n: int) -> list:
    """``t`` for each of ``n`` ranks: itself, then copies (each rank's
    value its own tensor, as in one process)."""
    return [t] + [t.clone() for _ in range(n - 1)]


def all_gather(x, *, gather_axis: int = 0):
    """The plain all-gather (every rank copies every block at once): x
    per rank, block r of the gathered dim; returns per rank the whole
    tensor."""
    mesh = _over_processes(x)
    W = len(x) if mesh is None else mesh.size
    record("all-gather", W * nbytes(x[0]), W, out=x[0])
    if mesh is not None:
        return _per_rank_copies(symm.all_gather(x, mesh, gather_axis),
                                len(x))
    return [torch.cat([to_device(t, d.device) for t in x], dim=gather_axis)
            for d in x]


def all_gather_devices(x, devices, *, gather_axis: int = -1):
    """The plain all-gather of per-rank blocks ``x`` into a replicated
    value: the whole tensor once on each of ``devices`` (a mesh's
    distinct devices: ranks that share a device share the copy), blocks
    in rank order. The decode sites' gathers (``core.patterns``)."""
    mesh = _over_processes(x)
    W = len(x) if mesh is None else mesh.size
    record("all-gather", W * nbytes(x[0]), W)
    if mesh is not None:
        whole = symm.all_gather(x, mesh, gather_axis)
        return [to_device(whole, d) for d in devices]
    return [torch.cat([to_device(t, d) for t in x], dim=gather_axis)
            for d in devices]


def all_reduce_devices(x, devices):
    """The plain all-reduce of per-rank partial tensors ``x`` (one
    shape) into a replicated value: their sum, in rank order, once on
    each of ``devices`` (a mesh's distinct devices), so every copy is
    the same."""
    mesh = _over_processes(x)
    record("all-reduce", nbytes(x[0]), len(x) if mesh is None else mesh.size)
    if mesh is not None:
        total = symm.all_reduce(x, mesh)
        return [to_device(total, d) for d in devices]
    out = []
    for d in devices:
        acc = None
        for t in x:
            t = to_device(t, d)
            acc = t if acc is None else acc + t
        out.append(acc)
    return out


def all_reduce(x):
    """The plain all-reduce: every rank sums every rank's tensor, in rank
    order, so every rank's sum is the same (x per rank, one shape)."""
    mesh = _over_processes(x)
    record("all-reduce", nbytes(x[0]), len(x) if mesh is None else
           mesh.size, out=x[0])
    if mesh is not None:
        return _per_rank_copies(symm.all_reduce(x, mesh), len(x))
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
    check_ag_gemm_k_sharded(K, b_r[0].shape[0], W, mode, axis)
    k = K // W
    shards = [a_r[r][..., r * k:(r + 1) * k].to(mesh.devices[r])
              for r in range(W)]
    return ag_gemm_k_sharded(shards, [x.to(mesh.devices[r]) for r, x in
                                      enumerate(b_r)], mode=mode)


def check_ag_gemm_k_sharded(K: int, Kb: int, W: int, mode: str,
                            axis: str = "model"):
    """JAX's shape checks of ``ag_gemm_k_sharded_sm`` on global sizes."""
    _check(K % W == 0,
           f"ag_gemm_k_sharded: K={K} must divide by the '{axis}' axis "
           f"size W={W} (A is K-sharded; a ragged shard would silently "
           f"drop columns)")
    _check(Kb == K,
           f"ag_gemm_k_sharded: A K dim {K} != B K dim {Kb}")
    _check(mode != "ring_bidir" or (K // W) % 2 == 0,
           f"ag_gemm_k_sharded: ring_bidir splits the local K shard "
           f"K/W={K // W} in half; it must be even — odd shards "
           f"mis-slice B's row blocks and return silently WRONG results "
           f"(measured max err ~5 on a unit test, not a rounding issue)")


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
