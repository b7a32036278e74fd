"""Fused all-gather + GEMM (port of the Pallas
``repro.kernels.ag_gemm.ag_gemm_fused``, the paper's §4.1 push model).

:func:`ag_gemm_fused` computes ``C = concat_K(A_0, ..., A_{W-1}) @ B`` on
every rank of a mesh, where rank r holds the K shard ``A_r`` (M, K/W)
and a replica of ``B`` (K, N). For CUDA tensors it launches the
hand-written kernel in ``csrc/ag_gemm.cu``, one cooperative launch per
card: shards of the card's own ranks are read in place, the others
arrive pushed into the card's first rank's inbox with a flag each, and
when the card's ranks pass one B tensor the product is computed once
and stored into every local output. For CPU tensors it runs
:func:`ag_gemm_plain`. At W = 1 it is the GEMM kernel
(``kernels.matmul``), as the JAX package's ``ops.ag_gemm`` routes it. A
CUDA call the kernel cannot take raises. :func:`ag_gemm_plan` sizes the
kernel's persistent grid.

Where other processes hold ranks of the mesh (``Mesh.spans``: a data
group's model axis split over them) the lists hold this process's
ranks: the launch passes their ids, W and the leaders of the mesh's
processes (each one's first rank), and the other
processes' shards arrive pushed through the heap's IPC-mapped inboxes
(``kernels.symm``); a peer that never arrives traps, nothing falls back.

Counters: ``ag_gemm_fused.launches`` (one per device per call) and
``ag_gemm_fused.plain_calls``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, symm
from repro_torch.kernels.matmul import matmul, matmul_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PUSHERS = 4                     # csrc/ag_gemm.cu PUSHERS
BK = 64                          # csrc/ag_gemm.cu BK: K rows of a tile
MIN_CHUNK_TILES = 8              # K tiles a chunk streams at least


@dataclasses.dataclass(frozen=True)
class AgGemmPlan:
    """The kernel's persistent grid (``csrc/ag_gemm.cu`` ``Items``): an
    item is (product, strip of ``bn`` output columns, K chunk), chunk
    fastest; chunk ``kc`` covers the strip's K tiles ``chunk_tiles(kc)``
    (tile t = rows [t % nk * BK, ...) of source t // nk). ``grid`` blocks
    walk the items (block i takes items i, i + grid, ...); a strip of
    several chunks sums their partials in chunk order."""
    n_prod: int
    n_strips: int
    bn: int
    tiles: int
    n_kc: int
    grid: int

    @property
    def items(self) -> int:
        return self.n_prod * self.n_strips * self.n_kc

    def chunk_tiles(self, kc: int) -> range:
        return range(kc * self.tiles // self.n_kc,
                     (kc + 1) * self.tiles // self.n_kc)

    def items_of(self, block: int) -> list[tuple[int, int, int]]:
        """(product, strip, chunk) of the items ``block`` computes."""
        per = self.n_strips * self.n_kc
        return [(i // per, i // self.n_kc % self.n_strips, i % self.n_kc)
                for i in range(block, self.items, self.grid)]


def ag_gemm_plan(M: int, N: int, k: int, W: int, itemsize: int,
                 n_prod: int, capacity: int) -> AgGemmPlan:
    """Strips of 256 bytes of B's row; K split into as many chunks as
    fill the ``capacity`` blocks the card holds at once with one
    product's strips (at least ``MIN_CHUNK_TILES`` tiles each). The
    chunking, and with it the summation order, depends only on the
    shapes and the capacity, never on ``n_prod``: ranks with their own
    product get the same sums as ranks that share one. (Stream-K, even
    shares of all strips' tiles that span strip boundaries, ran slower
    at the tp=4 ``wo`` shape: twice the partials, a longer tail.)"""
    bn = 256 // itemsize
    n_strips = -(-N // bn)
    tiles = W * -(-k // BK)
    n_kc = max(1, min(capacity // n_strips, tiles // MIN_CHUNK_TILES))
    return AgGemmPlan(n_prod, n_strips, bn, tiles, n_kc,
                      min(n_prod * n_strips * n_kc, capacity))


def ag_gemm_plain(a_shards, b):
    """The kernel's function in plain PyTorch: every rank "pushes" its
    shard by a copy into every rank's inbox, and each rank multiplies its
    gathered inbox by its B (fp32 product, output in A's dtype)."""
    out = []
    for br in b:
        inbox = [a.to(br.device, copy=True) for a in a_shards]
        out.append(matmul_plain(torch.cat(inbox, dim=-1), br))
    return out


def _lib():
    fn = _build.load("ag_gemm").ag_gemm_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 4 + [i32] * 9 + [ctypes.c_uint, ptr, ptr]
                       + [ptr, ptr, ptr, i32, i32, ctypes.c_longlong,
                          ctypes.c_longlong, ptr])
        fn.restype = ctypes.c_int
    return fn


def _per_sm_query():
    fn = _build.load("ag_gemm").ag_gemm_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def _vec(a, b, N, k, itemsize) -> bool:
    """The 16-byte copy path: rows of whole 16-byte words, aligned."""
    return (N * itemsize) % 16 == 0 and (k * itemsize) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (*a, *b))


def launch_card(a, b, c, ranks, mesh):
    """One launch on the card of ``ranks`` (its ranks of ``mesh``, the
    card's first rank first): ``a``, ``b``, ``c`` are those ranks'
    shards, B replicas and outputs. Returns nothing; raises on a launch
    error."""
    dev = a[0].device
    M, k = a[0].shape
    N = b[0].shape[1]
    dtype = a[0].dtype
    itemsize = a[0].element_size()
    n_local = len(ranks)
    shared = all(x.data_ptr() == b[0].data_ptr() for x in b)
    n_prod = 1 if shared else n_local
    vec = _vec(a, b, N, k, itemsize)
    call = symm.communicator(mesh).call(M * k * itemsize, _PUSHERS)
    cap = symm.capacity(dev, _per_sm_query(), M, _DTYPES[dtype], int(vec))
    plan = ag_gemm_plan(M, N, k, mesh.size, itemsize, n_prod, cap)
    work = cnt = None
    if plan.n_kc > 1:
        work = torch.empty((n_prod, plan.n_strips, plan.n_kc, M, plan.bn),
                           dtype=torch.float32, device=dev)
        cnt = symm.counters(dev, n_prod * plan.n_strips)
    leaders = sum(1 << r for r in mesh.job_leaders)
    with torch.cuda.device(dev):
        rc = _lib()(symm.ptrs(a), symm.ptrs(b), symm.ptrs(c), symm.ints(ranks), n_local, n_prod, M, N,
                    k, _DTYPES[dtype], int(vec), plan.n_kc, plan.grid,
                    leaders, None if work is None else work.data_ptr(),
                    None if cnt is None else cnt.data_ptr(),
                    *call.args(mesh.distinct.index(dev)),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ag_gemm_fused")


def ag_gemm_fused(a_shards, b, mesh=None):
    """``a_shards``: per rank (M, k); ``b``: per rank (W * k, N) (ranks on
    one device may pass the same tensor). Returns per rank (M, N) in A's
    dtype; every rank sums the sources in rank order with the same
    chunking, so the outputs are bit-identical on every rank. ``mesh``
    (the ranks' devices and their symmetric buffers) is needed for CUDA
    tensors at W > 1."""
    n = len(a_shards)
    if n == 0 or len(b) != n:
        raise ValueError(f"ag_gemm_fused: {len(a_shards)} A shards and "
                         f"{len(b)} B replicas")
    W = symm.width(a_shards, mesh)
    M, k = a_shards[0].shape
    K, N = b[0].shape
    for r in range(n):
        if a_shards[r].dim() != 2 or a_shards[r].shape != (M, k) \
                or b[r].shape != (K, N):
            raise ValueError(f"ag_gemm_fused: rank {r} shapes "
                             f"{tuple(a_shards[r].shape)} @ "
                             f"{tuple(b[r].shape)} differ from rank 0's")
    if K != W * k:
        raise ValueError(f"ag_gemm_fused: B rows K={K} must be W={W} times "
                         f"the local A shard width k={k}")
    if W == 1:
        return [matmul(a_shards[0], b[0])]
    if all(t.device.type == "cpu" for t in (*a_shards, *b)):
        ag_gemm_fused.plain_calls += 1
        return ag_gemm_plain(symm.every_rank(a_shards, mesh), b)
    dtype = a_shards[0].dtype
    for r in range(n):
        a, br = a_shards[r], b[r]
        if a.device.type != "cuda" or br.device != a.device \
                or (mesh is not None and mesh.devices[r] != a.device):
            raise ValueError(f"ag_gemm_fused: rank {r}'s operands must be "
                             f"on its CUDA device (A on {a.device}, B on "
                             f"{br.device})")
        if a.dtype != dtype or br.dtype != dtype or dtype not in _DTYPES:
            raise TypeError(f"ag_gemm_fused: kernel takes f32 x f32 or "
                            f"bf16 x bf16 on every rank, got {a.dtype} x "
                            f"{br.dtype}")
        if not (a.is_contiguous() and br.is_contiguous()):
            raise ValueError("ag_gemm_fused: operands must be contiguous "
                             "row-major")
    if W > 32:
        raise ValueError(f"ag_gemm_fused: at most 32 ranks, got {W}")
    outs: list = [None] * n
    if M == 0 or N == 0:
        return [torch.empty((M, N), dtype=dtype, device=a.device)
                for a in a_shards]
    groups = symm.rank_groups(a_shards)
    ids = symm.rank_ids(a_shards, mesh)
    if max(len(r) for r in groups.values()) > 8:
        raise ValueError("ag_gemm_fused: at most 8 ranks per device")
    for dev, ranks in groups.items():
        c = [torch.empty((M, N), dtype=dtype, device=dev) for _ in ranks]
        launch_card([a_shards[r] for r in ranks], [b[r] for r in ranks], c,
                    [ids[r] for r in ranks], mesh)
        for r, t in zip(ranks, c):
            outs[r] = t
    ag_gemm_fused.launches += len(groups)
    return outs


ag_gemm_fused.launches = 0
ag_gemm_fused.plain_calls = 0
