"""GEMM: ``C = A @ B`` with an fp32 accumulator (port of the Pallas
``repro.kernels.matmul.matmul``).

:func:`matmul` is what the model calls for the decode projections and
the unembed; :func:`matmul_group` computes several products of one A in
one launch (wq/wk/wv, wg/wu); :func:`matmul_batched` the E products of
a batch (the MoE layer's experts) in one launch. For CUDA tensors they
launch the
hand-written kernels in ``csrc/matmul.cu``: the streaming kernel
``gemm_stream`` (a persistent grid sized by :func:`gemm_plan`) for
operands TMA can take, the general ``mm_kernel`` for other shapes and
pointers; for CPU tensors they run :func:`matmul_plain`. There is no
fallback between the two: a CUDA tensor the kernels cannot take raises.

Gradients: where autograd records (an input requires grad and grad
mode is on), the wrappers run as ``torch.autograd.Function``s whose
backward is the same kernel (``dA = dC @ B^T``, ``dB = A^T @ dC``), on
the card and, through the plain version, on the CPU alike. Otherwise
(``torch.no_grad``, ``torch.inference_mode``: the engine and its CUDA
graphs) they launch the forward product alone and save nothing.

Counters, shared by the wrappers (one kernel): ``matmul.launches``
counts kernel launches and ``matmul.plain_calls`` plain-version calls (a
group or a batch counts one of either), backward products included, so
a run can show which one its main path went through; the batched mode
also counts its own in ``matmul_batched.launches`` / ``plain_calls``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import _build, symm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KN_MMA, KN_FMA, TRANS = 0, 1, 2    # csrc/matmul.cu Path
MAX_GROUP = 4                      # csrc/matmul.cu MAXP
TILE_BYTES = 16384                 # csrc/matmul.cu TILE_B: B per stage
MIN_CHUNK_TILES = 8                # K tiles a chunk streams at least
SPAN_SLACK = 1 / 2                 # gemm_plan: fewer chunks within this


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 trans_b: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 product, output in
    ``a``'s dtype. ``b`` is (K, N), or (N, K) with ``trans_b``."""
    bf = b.float().T if trans_b else b.float()
    return (a.float() @ bf).to(a.dtype)


def matmul_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`matmul_batched`'s arithmetic in plain PyTorch: fp32
    products, output in ``a``'s dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One product's share of ``gemm_stream``'s persistent grid
    (``csrc/matmul.cu``): ``n_strips`` strips of ``bn`` output columns,
    K in ``tiles`` tiles of ``kt``, M in ``m_tiles`` tiles of ``mt``
    rows; each strip split into ``n_mc`` M chunks or ``n_kc`` K chunks
    (one of the two is 1). An item is (strip, M chunk, K chunk), K chunk
    fastest; K chunk ``kc`` covers tiles ``chunk_tiles(kc)``, M chunk
    ``mc`` the M tiles ``m_chunk(mc)``. A strip of several K chunks sums
    their partials in chunk order; an M chunk writes its rows of C. A
    batch of ``E`` matrices repeats this for each: an item is (matrix,
    strip, M chunk, K chunk)."""
    M: int
    bn: int
    kt: int
    n_strips: int
    tiles: int
    n_kc: int
    mt: int
    n_mc: int
    E: int = 1

    @property
    def m_tiles(self) -> int:
        return -(-self.M // self.mt)

    @property
    def items(self) -> int:
        return self.E * self.n_strips * self.n_mc * self.n_kc

    def chunk_tiles(self, kc: int) -> range:
        return range(kc * self.tiles // self.n_kc,
                     (kc + 1) * self.tiles // self.n_kc)

    def m_chunk(self, mc: int) -> range:
        return range(mc * self.m_tiles // self.n_mc,
                     (mc + 1) * self.m_tiles // self.n_mc)

    @property
    def work_floats(self) -> int:
        """fp32 partials of the product's split strips: the split-K
        workspace, held with the launch (``_LAUNCHES``) for the life of
        the process."""
        return 0 if self.n_kc == 1 else \
            self.E * self.n_strips * self.n_kc * self.M * self.bn


def geometry(path: int, itemsize: int) -> tuple[int, int]:
    """(bn, kt) of a path (``csrc/matmul.cu`` ``Geo``): output columns of
    a strip and K elements of a tile; a tile is 16 KB of B. B (K, N):
    strips of 256 bytes of B's rows; B (N, K) (TRANS): strips of table
    rows, tiles of 256 K elements."""
    if path == TRANS:
        return TILE_BYTES // (256 * itemsize), 256
    return 256 // itemsize, TILE_BYTES // 256


def m_tile(path: int, M: int) -> int:
    """Rows of an A tile of ``gemm_stream`` (``csrc/matmul.cu`` ``MT``):
    bf16 B (K, N) on the tensor cores in tiles of 8 batch rows or 16;
    fp32 B (K, N) and B (N, K) on fp32 FMA in tiles of 8."""
    return 16 if path == KN_MMA and M > 8 else 8


def gemm_plan(M: int, N: int, K: int, itemsize: int, capacity: int,
              path: int | None = None, E: int = 1) -> GemmPlan:
    """One product's strips and chunks for ``path`` (default: KN_MMA
    for bf16, KN_FMA for fp32; TRANS for B given as (N, K)), see
    :func:`geometry`; for a batch of ``E`` products, the strips of all
    E count together. Where the strips' M tiles alone fill the
    ``capacity`` blocks (training shapes), M is split: the fewest M
    chunks that finish the product soonest, every block taking items in
    turn, and no K split, so no split-K workspace. Otherwise (decode: M
    is the batch) K is split: the chunks per strip are those that finish
    the product's tiles soonest, at least ``MIN_CHUNK_TILES`` tiles a
    chunk; since each chunk leaves a partial and the strip a fold, the
    fewest chunks within ``SPAN_SLACK`` of the soonest. The chunking,
    and with it every bit of C, depends only on the product's shape (E
    included) and the card, never on the group it is launched in."""
    if path is None:
        path = KN_MMA if itemsize == 2 else KN_FMA
    bn, kt = geometry(path, itemsize)
    mt = m_tile(path, M)
    n_strips = -(-N // bn)
    strips = E * n_strips
    tiles = -(-K // kt)
    m_tiles = -(-M // mt)
    if strips * m_tiles >= capacity:
        span = {n_mc: -(-strips * n_mc // capacity) * -(-m_tiles // n_mc)
                for n_mc in range(1, m_tiles + 1)}
        soonest = min(span.values())
        n_mc = min(n for n, t in span.items() if t == soonest)
        return GemmPlan(M, bn, kt, n_strips, tiles, 1, mt, n_mc, E)
    span = {n_kc: -(-strips * n_kc // capacity) * -(-tiles // n_kc)
            for n_kc in range(1, max(1, tiles // MIN_CHUNK_TILES) + 1)}
    soonest = min(span.values())
    n_kc = min(n for n, t in span.items() if t <= soonest * (1 + SPAN_SLACK))
    return GemmPlan(M, bn, kt, n_strips, tiles, n_kc, mt, 1, E)


def _path(M: int, dtype, trans_b: bool) -> tuple[int, int]:
    """(path, rows of an A tile) of ``gemm_stream`` (:func:`m_tile`)."""
    path = TRANS if trans_b else KN_MMA if dtype == torch.bfloat16 \
        else KN_FMA
    return path, m_tile(path, M)


_FNS: dict = {}


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("matmul"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch_general(a, b, c, trans_b):
    """One ``mm_kernel`` launch: ``a`` (M, K) or a batch (E, M, K)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _fn("mm_launch", [ptr, ptr, ptr] + [i32] * 6 + [ptr])
    M, K = a.shape[-2:]
    E = a.shape[0] if a.dim() == 3 else 1
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), E, M, c.shape[-1], K,
            int(trans_b), _DTYPES[a.dtype],
            torch.cuda.current_stream(a.get_device()).cuda_stream)
    _build.check(rc, "matmul")


@dataclasses.dataclass(frozen=True)
class _Launch:
    """A ``gemm_stream`` launch of one set of shapes, all but the
    pointers of A, B and C and the stream: ``args``, the plan as
    ``gemm_launch`` takes it after those pointers (widths, chunks,
    dtype, path, A tile rows, grid, workspace, counters), and the
    launch's own split-K workspace and strip counters behind them.
    Launches of one set of shapes share these buffers; stream order
    keeps them apart."""
    fn: Callable[..., int]
    args: tuple
    bufs: tuple


_LAUNCHES: dict = {}


def _plan_launch(a, Ns, trans_b) -> _Launch:
    """The launch for ``a``'s shape ((M, K), or (E, M, K) for a batch),
    dtype and device against products of widths ``Ns``. Planned at the
    first call of these shapes, which allocates the launch's buffers:
    make it outside a CUDA graph capture (a warm-up call)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"matmul: first call of shapes {tuple(a.shape)} x {Ns} inside "
            f"a CUDA graph capture; warm up these shapes before capturing")
    M, K = a.shape[-2:]
    E = a.shape[0] if a.dim() == 3 else 1
    path, mt = _path(M, a.dtype, trans_b)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    per_sm = _fn("gemm_blocks_per_sm", [i32] * 3 + [ctypes.POINTER(i32)])
    cap = symm.capacity(a.device, per_sm, path, _DTYPES[a.dtype], mt)
    plans = [gemm_plan(M, N, K, a.element_size(), cap,
                       TRANS if trans_b else None, E) for N in Ns]
    split = [p for p in plans if p.n_kc > 1]
    work = cnt = None
    if split:
        work = torch.empty(sum(p.work_floats for p in split),
                           dtype=torch.float32, device=a.device)
        cnt = torch.zeros(sum(E * p.n_strips for p in split),
                          dtype=torch.int32, device=a.device)
    fn = _fn("gemm_launch", [ptr, ptr, ptr] + [i32] * 4 + [ptr] * 3
             + [i32] * 4 + [ptr, ptr, ptr])
    args = (symm.ints(Ns), symm.ints([p.n_kc for p in plans]),
            symm.ints([p.n_mc for p in plans]),
            _DTYPES[a.dtype], path, mt, min(sum(p.items for p in plans), cap),
            None if work is None else work.data_ptr(),
            None if cnt is None else cnt.data_ptr())
    return _Launch(fn, args, (work, cnt))


def _launch_stream(a, bs, cs, trans_b):
    """One ``gemm_stream`` launch for the products ``a @ bs[p]`` into
    ``cs[p]`` (``a`` (M, K), or (E, M, K) with ``bs`` and ``cs``
    batches of E matrices too)."""
    M, K = a.shape[-2:]
    E = a.shape[0] if a.dim() == 3 else 1
    Ns = tuple(c.shape[-1] for c in cs)
    key = (a.get_device(), a.dtype, M, K, trans_b, Ns, E)
    lp = _LAUNCHES.get(key)
    if lp is None:
        lp = _LAUNCHES[key] = _plan_launch(a, Ns, trans_b)
    rc = lp.fn(a.data_ptr(), symm.ptrs(bs), symm.ptrs(cs), len(bs), E, M,
               K, *lp.args, torch.cuda.current_stream(key[0]).cuda_stream)
    _build.check(rc, "matmul")


def _check(a, bs, trans_b, name) -> tuple[bool, bool]:
    """Shapes, devices and dtypes of ``a @ b`` for every b. Returns
    (whether all operands are CPU tensors, whether the streaming kernel
    takes them: rows of whole 16-byte words, 16-byte aligned
    pointers)."""
    if a.dim() != 2:
        raise ValueError(f"{name} takes 2-D operands, got a "
                         f"{tuple(a.shape)}")
    K = a.shape[1]
    cpu = not a.is_cuda
    card = a.get_device()        # -1 on the CPU
    s = a.element_size()
    tma = (K * s) % 16 == 0 and a.data_ptr() % 16 == 0
    for b in bs:
        if b.dim() != 2 or (b.shape[1] if trans_b else b.shape[0]) != K:
            raise ValueError(f"{name}: a {tuple(a.shape)} @ b "
                             f"{tuple(b.shape)} (trans_b={trans_b})")
        if b.get_device() != card:
            raise ValueError(f"{name} operands on {a.device} and "
                             f"{b.device}: all must be CPU tensors or on "
                             f"one CUDA device")
        if cpu:
            continue
        if b.dtype != a.dtype or a.dtype not in _DTYPES:
            raise TypeError(f"{name} kernel takes f32 x f32 or bf16 x "
                            f"bf16, got {a.dtype} x {b.dtype}")
        if not b.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous row-major "
                             f"operands")
        tma = tma and b.data_ptr() % 16 == 0 and (
            trans_b or (b.shape[1] * s) % 16 == 0)
    if not cpu and not a.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous row-major operands")
    return cpu, tma


def _run(a, bs, trans_b, tma):
    """The CUDA products ``a @ b`` for every b: one ``gemm_stream`` launch
    when TMA takes every operand, else one general launch per product.
    Counts the launches."""
    M, K = a.shape
    cs = [torch.empty((M, b.shape[0] if trans_b else b.shape[1]),
                      dtype=a.dtype, device=a.device) for b in bs]
    live = [(b, c) for b, c in zip(bs, cs) if c.numel()]
    if not live:
        return cs
    if K == 0:
        return [c.zero_() for c in cs]
    if tma:
        _launch_stream(a, [b for b, _ in live], [c for _, c in live],
                       trans_b)
        matmul.launches += 1
    else:
        for b, c in live:
            _launch_general(a, b, c, trans_b)
            matmul.launches += 1
    return cs


def _product(a, b, trans_b=False):
    """The product alone: the kernel for CUDA tensors, the plain version
    for CPU tensors; records nothing for autograd."""
    cpu, tma = _check(a, [b], trans_b, "matmul")
    if cpu:
        matmul.plain_calls += 1
        return matmul_plain(a, b, trans_b)
    return _run(a, [b], trans_b, tma)[0]


def _products(a, bs):
    """:func:`_product` for every b of a group, in one launch."""
    cpu, tma = _check(a, bs, False, "matmul_group")
    if cpu:
        matmul.plain_calls += 1
        return [matmul_plain(a, b) for b in bs]
    return _run(a, bs, False, tma)


def _grad_a(dc, b, trans_b):
    """dA of ``a @ b`` (``b`` (K, N)) or of ``a @ b.T`` (``trans_b``, ``b``
    (N, K)) for the output gradient ``dc``. For ``b`` (K, N), B^T is made
    contiguous so the product runs on its own path (the tensor cores for
    bf16): reading B transposed instead (the TRANS path, fp32 FMA) ran
    3.7-4.7x slower at the training shapes (chip_smoke.py phase 12a,
    PERF.md)."""
    if trans_b:
        return _product(dc, b)
    return _product(dc, b.t().contiguous())


class _Matmul(torch.autograd.Function):
    """:func:`matmul` with its gradient: dA = dC @ B^T (:func:`_grad_a`),
    dB = A^T @ dC (dB = dC^T @ A for ``trans_b``), each one product of
    the same kernel."""

    @staticmethod
    def forward(ctx, a, b, trans_b):
        ctx.save_for_backward(a, b)
        ctx.trans_b = trans_b
        return _product(a, b, trans_b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _grad_a(dc, b, ctx.trans_b)
        if ctx.needs_input_grad[1]:
            db = _product(dc.t().contiguous(), a) if ctx.trans_b \
                else _product(a.t().contiguous(), dc)
        return da, db, None


class _MatmulGroup(torch.autograd.Function):
    """:func:`matmul_group` with its gradient: every dB_p = A^T @ dC_p in
    one grouped launch; dA = sum_p dC_p @ B_p^T, the terms summed in fp32
    in product order (so the sum does not depend on scheduling), cast
    to A's dtype."""

    @staticmethod
    def forward(ctx, a, *bs):
        ctx.save_for_backward(a, *bs)
        return tuple(_products(a, list(bs)))

    @staticmethod
    def backward(ctx, *dcs):
        a, *bs = ctx.saved_tensors
        dcs = [dc.contiguous() for dc in dcs]
        da = None
        if ctx.needs_input_grad[0]:
            for dc, b in zip(dcs, bs):
                term = _grad_a(dc, b, False).float()
                da = term if da is None else da + term
            da = da.to(a.dtype)
        dbs = [None] * len(bs)
        if any(ctx.needs_input_grad[1:]):
            dbs = [db if need else None for db, need in zip(
                _products(a.t().contiguous(), dcs), ctx.needs_input_grad[1:])]
        return (da, *dbs)


def _records(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           trans_b: bool = False) -> torch.Tensor:
    """``a`` (M, K) @ ``b`` (K, N) -> (M, N) in ``a``'s dtype; with
    ``trans_b``, ``b`` is given as (N, K) and read transposed. Any M, N,
    K; f32 x f32 or bf16 x bf16. Differentiable (module docstring)."""
    if _records(a, b):
        return _Matmul.apply(a, b, trans_b)
    return _product(a, b, trans_b)


def matmul_group(a: torch.Tensor, bs) -> list[torch.Tensor]:
    """``[a @ b for b in bs]`` for ``a`` (M, K) and each ``b`` (K, N_i),
    in one launch (at most ``MAX_GROUP`` products). Each product's
    chunking depends only on its own shape, so its output is
    bit-identical to :func:`matmul`'s. Differentiable (module
    docstring)."""
    bs = list(bs)
    if not 1 <= len(bs) <= MAX_GROUP:
        raise ValueError(f"matmul_group takes 1 to {MAX_GROUP} products, "
                         f"got {len(bs)}")
    if _records(a, *bs):
        return list(_MatmulGroup.apply(a, *bs))
    return _products(a, bs)


def _check_batched(a, b) -> tuple[bool, bool]:
    """:func:`_check` for ``a`` (E, M, K) @ ``b`` (E, K, N)."""
    if a.dim() != 3 or b.dim() != 3 or b.shape[0] != a.shape[0] \
            or b.shape[1] != a.shape[2]:
        raise ValueError(f"matmul_batched: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    if b.get_device() != a.get_device():
        raise ValueError(f"matmul_batched operands on {a.device} and "
                         f"{b.device}: both must be CPU tensors or on one "
                         f"CUDA device")
    if not a.is_cuda:
        return True, False
    if b.dtype != a.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"matmul_batched kernel takes f32 x f32 or bf16 x "
                        f"bf16, got {a.dtype} x {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_batched kernel needs contiguous operands")
    s = a.element_size()
    tma = ((a.shape[2] * s) % 16 == 0 and (b.shape[2] * s) % 16 == 0
           and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    return False, tma


def _product_batched(a, b):
    """The E products alone, in one launch (the plain version for CPU
    tensors); records nothing for autograd."""
    cpu, tma = _check_batched(a, b)
    if cpu:
        matmul.plain_calls += 1
        matmul_batched.plain_calls += 1
        return matmul_batched_plain(a, b)
    E, M, K = a.shape
    c = torch.empty((E, M, b.shape[2]), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    if tma:
        _launch_stream(a, [b], [c], False)
    else:
        _launch_general(a, b, c, False)
    matmul.launches += 1
    matmul_batched.launches += 1
    return c


class _MatmulBatched(torch.autograd.Function):
    """:func:`matmul_batched` with its gradient, each one batched launch
    of the same kernel: dA = dC @ B^T (B^T made contiguous, as
    :func:`_grad_a`), dB = A^T @ dC."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_batched(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product_batched(dc, b.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            db = _product_batched(a.transpose(1, 2).contiguous(), dc)
        return da, db


def matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (E, M, K) @ ``b`` (E, K, N) -> (E, M, N) in ``a``'s dtype:
    the E products of a batch (the MoE layer's experts) in ONE launch.
    Any E, M, N, K; f32 x f32 or bf16 x bf16. Differentiable (module
    docstring)."""
    if _records(a, b):
        return _MatmulBatched.apply(a, b)
    return _product_batched(a, b)


matmul.launches = 0
matmul.plain_calls = 0
matmul_batched.launches = 0
matmul_batched.plain_calls = 0
