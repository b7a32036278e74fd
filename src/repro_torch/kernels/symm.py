"""Symmetric buffers of a mesh for the fused multi-rank kernels (the
Python half of ``csrc/symm.cuh``).

A :class:`Communicator` belongs to one :class:`Mesh` (``mesh.symm``) and
is shared by the fused AG+GEMM and the two fused flash decodes. Per rank
it holds an inbox (two parities of W source slots) and a flag array (W
sources x ``n_chunk`` words) on the rank's device, plus, on every
distinct device, the device arrays of the W inbox and flag base
addresses that the kernels index. Buffers grow on demand and are never
shrunk; growing waits for every device of the mesh first (the new
buffers' zeros must land before a peer writes into them). Superseded
buffers stay alive with the communicator: a CUDA graph captured before
a growth keeps their pointers and replays into them.

The epoch lives in device memory: each distinct device holds one 64-bit
word (``Communicator.state``), the epoch in its high half and a count of
the blocks that have taken it in its low half. Every block of a fused
launch takes the word with one atomic add and runs with epoch + 1; the
last block stores epoch + 1 with a zero count (``csrc/symm.cuh``
``take_epoch``). So the host never counts epochs, and a CUDA graph that
captured a fused call replays it with a fresh epoch each time. When the
buffers grow the flags restart at 0 and the words keep their values.
Inboxes are zeroed when allocated: the fused paged decode's records
travel as LL lines that carry their own epoch, and a recycled buffer
could hold lines of another mesh's epochs.

:func:`counters` hands the kernels a per-device array of arrival
counters that every kernel leaves at zero (split and split-K folds),
also kept alive when a larger array supersedes them, and
:func:`sm_count` / :func:`capacity` give the sizes the launch plans
take. Buffers are sized before a call is captured into a CUDA graph (a
warm-up call does it): growing inside a capture raises.

Over processes (a mesh that other processes hold ranks of,
``Mesh.spans``: a data group's model ranks that several processes
split, a model rank's data peers, the whole mesh) the communicator
holds this process's ranks' inboxes
and flags in the symmetric heap: ``cudaMalloc`` allocations (a CUDA IPC
handle names a whole allocation, so not PyTorch's caching allocator;
:attr:`Communicator.heap_bytes` counts them, since
``torch.cuda.max_memory_allocated`` cannot see them), zeroed, their
handles published through the job's store, and every peer's opened once
(``csrc/symm.cuh`` ``symm_heap_*``); the W-entry tables hold the local
pointers and the opened ones. A growth happens at the same call in
every process (they make the same calls); no process writes a peer's
new buffers before it has collected their handles, which the peer
publishes only once its zeros have landed: the store is the barrier.
Retired buffers stay mapped, as captured graphs may replay into them,
until :func:`close`. Every process of a mesh runs the same sequence of
fused and exchange calls on it, so the epoch words of its processes
stay equal; each span (``Mesh.span``) has its communicator, heap, store
keys (its ranks) and epoch.

:func:`every_rank`, :func:`all_gather` and :func:`all_reduce` are the
collectives over processes: on the card one launch of the hand-written
``csrc/symm_exchange.cu`` (:func:`exchange`, the fused kernels'
protocol: push, flag, wait, then the blocks joined or summed in rank
order), on the CPU the gloo link of the mesh's processes
(``Mesh.link``); values are bit-identical to the same collective over
the same ranks in one process.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build


# ranks one device carries in a fused launch (csrc/symm.cuh MAX_RANKS)
MAX_RANKS = 8


def check_virtual_ranks(devices):
    """Raise where a CUDA device carries more ranks of one mesh than a
    fused launch takes (:data:`MAX_RANKS`): such a mesh of virtual ranks
    cannot run the fused kernels, and nothing falls back to their plain
    versions on the card. ``devices``: one ``torch.device`` per rank."""
    n: dict = {}
    for d in devices:
        if d.type == "cuda":
            n[d] = n.get(d, 0) + 1
    over = {str(d): k for d, k in n.items() if k > MAX_RANKS}
    if over:
        raise ValueError(
            f"{over} ranks on one card: the fused kernels take at most "
            f"MAX_RANKS={MAX_RANKS} virtual ranks a device "
            f"(csrc/symm.cuh); list at most {MAX_RANKS} ranks a card")


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass
class Call:
    """What one fused launch passes to its kernels."""
    slot_bytes: int
    half: int
    n_chunk: int
    W: int
    tables: list          # per distinct device: (inbox_tab, flag_tab, state)

    def args(self, i: int) -> tuple:
        """The symmetric-buffer arguments of the launch on distinct
        device ``i``, in the order of the kernels' C interfaces."""
        inbox_tab, flag_tab, state = self.tables[i]
        return (inbox_tab.data_ptr(), flag_tab.data_ptr(), state.data_ptr(),
                self.W, self.n_chunk, self.slot_bytes, self.half)


class Communicator:
    def __init__(self, mesh):
        if any(d.type != "cuda" for d in mesh.devices):
            raise ValueError(f"symmetric buffers need CUDA ranks, got "
                             f"{mesh}")
        self.mesh = mesh
        # over processes: the heap's owned and opened pointers, the bytes
        # this process allocated, and the store keys' namespace (the
        # mesh's ranks, and how many communicators over them this
        # process made before: the same in every process of the mesh)
        self.procs = mesh.procs if split(mesh) else None
        self.owned: list[int] = []
        self.opened: list[int] = []
        self.heap_bytes = 0
        self.gen = 0
        if self.procs is not None:
            ranks = ",".join(map(str, mesh.ranks))
            _SEQ[ranks] = _SEQ.get(ranks, 0) + 1
            self.key = f"symm/{ranks}/{_SEQ[ranks]}"
        self.half = 0          # inbox bytes per parity
        self.n_chunk = 0
        self.inbox: list[torch.Tensor] = []
        self.flags: list[torch.Tensor] = []
        self.tables: list[tuple[torch.Tensor, ...]] = []
        # superseded (inbox, flags, tables), alive for captured graphs
        self.retired: list[tuple[list, ...]] = []
        # per distinct device: the 64-bit word (count, epoch) as two
        # int32 halves, advanced by the kernels
        self.state = [torch.zeros(2, dtype=torch.int32, device=d)
                      for d in mesh.distinct]
        cards = [d.index for d in mesh.distinct]
        if len(cards) > 1:
            fn = _build.load("ag_gemm").symm_enable_peer
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
            for a in cards:
                for b in cards:
                    if a != b:
                        _build.check(fn(a, b), f"peer access cuda:{a} -> "
                                               f"cuda:{b}")

    def _grow(self, half: int, n_chunk: int):
        _no_capture("the symmetric buffers")
        for d in self.mesh.distinct:
            torch.cuda.synchronize(d)
        if self.tables:
            self.retired.append((self.inbox, self.flags, self.tables))
        W = self.mesh.size
        self.half, self.n_chunk = half, n_chunk
        if self.procs is not None:
            ib, fl = self._grow_heap(half, n_chunk)
        else:
            # zeros: LL lines (csrc/symm.cuh) carry their epoch, and a
            # recycled buffer could hold lines of another mesh's epochs
            self.inbox = [torch.zeros(2 * half, dtype=torch.uint8, device=d)
                          for d in self.mesh.devices]
            self.flags = [torch.zeros(W * n_chunk, dtype=torch.int32,
                                      device=d)
                          for d in self.mesh.devices]
            ib = [t.data_ptr() for t in self.inbox]
            fl = [t.data_ptr() for t in self.flags]
        self.tables = [(_upload(ib, d), _upload(fl, d), st)
                       for d, st in zip(self.mesh.distinct, self.state)]

    def _grow_heap(self, half: int, n_chunk: int) -> tuple:
        """New zeroed heap buffers for this process's ranks, their
        handles exchanged with the mesh's processes through the store
        and the peers' opened: the W inbox and flag bases, rank order
        (process q's ranks the q-th block of ``len(mesh.local)``)."""
        from repro_torch.distributed import processes
        mesh, lib = self.mesh, _heap_lib()
        W, hb = mesh.size, lib.symm_handle_bytes()
        mine, handles = {}, b""
        with torch.cuda.device(mesh.devices[0]):
            for r in mesh.local:
                for size in (2 * half, 4 * W * n_chunk):
                    ptr, h = ctypes.c_void_p(), ctypes.create_string_buffer(hb)
                    _build.check(lib.symm_heap_alloc(size, ctypes.byref(ptr),
                                                     h), "symm_heap_alloc")
                    self.owned.append(ptr.value)
                    self.heap_bytes += size
                    mine.setdefault(r, []).append(ptr.value)
                    handles += h.raw
            self.gen += 1
            key = f"{self.key}/{self.gen}"
            members = mesh.peers
            processes.publish(self.procs, key, handles)
            n = len(mesh.local)
            for q, got in zip(members, processes.collect(self.procs, key,
                                                         members)):
                if q == self.procs.rank:
                    continue
                lo = members.index(q) * n
                for i in range(n):
                    ptrs = []
                    for j in range(2):
                        at = (2 * i + j) * hb
                        ptr = ctypes.c_void_p()
                        _build.check(lib.symm_heap_open(
                            got[at:at + hb], ctypes.byref(ptr)),
                            f"symm_heap_open (rank {lo + i})")
                        self.opened.append(ptr.value)
                        ptrs.append(ptr.value)
                    mine[lo + i] = ptrs
        return ([mine[r][0] for r in range(W)],
                [mine[r][1] for r in range(W)])

    def unmap(self):
        """Unmap the peers' heap buffers (after the last launch)."""
        if not self.opened:
            return
        lib = _heap_lib()
        torch.cuda.synchronize(self.mesh.devices[0])
        with torch.cuda.device(self.mesh.devices[0]):
            for p in self.opened:
                _build.check(lib.symm_heap_close(ctypes.c_void_p(p)),
                             "symm_heap_close")
        self.opened = []

    def free(self):
        """Free this process's heap buffers (once every peer unmapped
        them)."""
        lib = _heap_lib() if self.owned else None
        with torch.cuda.device(self.mesh.devices[0]):
            for p in self.owned:
                _build.check(lib.symm_heap_free(ctypes.c_void_p(p)),
                             "symm_heap_free")
        self.owned = []
        self.heap_bytes = 0


    def epoch(self, i: int = 0) -> int:
        """The epoch of distinct device ``i``: the number of fused
        launches it has run on this mesh (reads the card: synchronises)."""
        return int(self.state[i][1])

    def call(self, slot_bytes: int, n_chunk: int) -> Call:
        """Reserve inboxes of W slots of ``slot_bytes`` and ``n_chunk``
        flags per source for one fused launch; returns the pointer
        tables (the epoch is the kernels' business)."""
        W = self.mesh.size
        slot = _align16(slot_bytes)
        if W * slot > self.half or n_chunk > self.n_chunk:
            self._grow(max(W * slot, self.half), max(n_chunk, self.n_chunk))
        return Call(slot, self.half, self.n_chunk, W, self.tables)


_SEQ: dict = {}    # communicators over processes made, by their ranks
_CLOSES = [0]      # close() calls over processes made so far (store keys)


def close(comms, mesh):
    """Release the heap buffers of ``comms`` (communicators of ``mesh``
    and of its spans): every process of ``mesh`` unmaps what it opened,
    waits at one barrier for all of them, then frees what it owns; every
    process calls it alike, after the last launch. Nothing in one
    process."""
    comms = [c for c in comms if c.procs is not None]
    if not split(mesh):
        return
    from repro_torch.distributed import processes
    for c in comms:
        c.unmap()
    _CLOSES[0] += 1
    processes.barrier(mesh.procs, f"symm/closed/{_CLOSES[0]}", mesh.peers)
    for c in comms:
        c.free()


def _heap_lib():
    lib = _build.load("symm_exchange")
    if lib.symm_heap_alloc.argtypes is None:
        ptr = ctypes.c_void_p
        lib.symm_heap_alloc.argtypes = [ctypes.c_longlong,
                                        ctypes.POINTER(ptr), ctypes.c_char_p]
        lib.symm_heap_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ptr)]
        lib.symm_heap_close.argtypes = [ptr]
        lib.symm_heap_free.argtypes = [ptr]
        for f in (lib.symm_heap_alloc, lib.symm_heap_open,
                  lib.symm_heap_close, lib.symm_heap_free,
                  lib.symm_handle_bytes):
            f.restype = ctypes.c_int
    return lib


def communicator(mesh) -> Communicator:
    """The mesh's communicator, created on first use."""
    if mesh is None:
        raise ValueError("a fused multi-rank kernel needs the mesh of its "
                         "ranks (mesh=...)")
    if mesh.symm is None:
        mesh.symm = Communicator(mesh)
    return mesh.symm


def _upload(values, device) -> torch.Tensor:
    """An int64 device array of ``values``, copied from pinned memory
    with ``non_blocking=True`` (a pageable copy would synchronize; the
    caching host allocator keeps the pinned block until its copy ran)."""
    return torch.tensor(values, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)


def _no_capture(what: str):
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} cannot grow inside a CUDA graph capture; make a "
            f"warm-up call of the same shapes before capturing")


_COUNTERS: dict[torch.device, torch.Tensor] = {}
_RETIRED_COUNTERS: list[torch.Tensor] = []   # alive for captured graphs
_SM_COUNT: dict[int, int] = {}
_PER_SM: dict[tuple, int] = {}


def counters(device, n: int) -> torch.Tensor:
    """``n`` (or more) uint32 arrival counters on ``device``, zero; the
    kernels leave them at zero. Grown on demand: a grown array is fresh
    zeros, and the one it supersedes stays alive for the graphs that
    captured it."""
    device = torch.device(device)
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        _no_capture("the arrival counters")
        if buf is not None:
            _RETIRED_COUNTERS.append(buf)
        buf = torch.zeros(max(n, 1024, 0 if buf is None else
                              2 * buf.numel()),
                          dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    idx = torch.device(device).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def capacity(device, fn, *key) -> int:
    """Blocks of a kernel that fit on ``device`` at once: its SM count
    times ``fn(*key, byref(out))``, a ``*_blocks_per_sm`` C query; cached
    per device and key."""
    device = torch.device(device)
    cache_key = (device, fn.__name__, *key)
    if cache_key not in _PER_SM:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(fn(*key, ctypes.byref(out)), fn.__name__)
        if out.value <= 0:
            raise RuntimeError(f"{fn.__name__}{key}: no block fits an SM")
        _PER_SM[cache_key] = out.value
    return _PER_SM[cache_key] * sm_count(device)


def rank_groups(tensors) -> dict:
    """Ranks grouped by the device of their tensor, in rank order."""
    groups: dict[torch.device, list[int]] = {}
    for r, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(r)
    return groups


def ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


# ---------------------------------------------- collectives over processes
_OPS = {"gather": 0, "sum": 1}
_SUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_BYTES = 1 << 16            # bytes a block of an exchange pushes


def split(mesh) -> bool:
    """Whether other processes hold ranks of ``mesh`` (``Mesh.spans``:
    its per-rank lists then hold this process's ranks only)."""
    return mesh is not None and mesh.spans


def width(blocks, mesh) -> int:
    """W: every rank of ``mesh`` (``mesh.size``) where processes share
    it, else ``len(blocks)`` (every rank here)."""
    return mesh.size if split(mesh) else len(blocks)


def rank_ids(blocks, mesh) -> list:
    """The rank of each entry of a per-rank list: ``mesh.local`` where
    processes share ``mesh``, else 0 .. len - 1."""
    return list(mesh.local) if split(mesh) else list(range(len(blocks)))


def _exchange_lib():
    lib = _build.load("symm_exchange")
    fn = lib.symm_exchange_launch
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr, ptr] + [i32] * 4 + [i64, i64, ctypes.c_uint,
                                                  ptr, i32, ptr, ptr, ptr,
                                                  i32, i32, i64, i64, ptr])
        fn.restype = ctypes.c_int
        q = lib.symm_exchange_blocks_per_sm
        q.argtypes = [ctypes.POINTER(ctypes.c_int)]
        q.restype = ctypes.c_int
    return lib


def exchange_plan(nbytes: int, capacity: int) -> int:
    """The exchange's grid: a block per :data:`CHUNK_BYTES` of one rank's
    block, at least one, at most what the card holds at once."""
    return max(1, min(capacity, -(-nbytes // CHUNK_BYTES)))


def exchange(blocks, mesh, op: str = "gather", axis: int = 0):
    """One launch of ``csrc/symm_exchange.cu`` over this process's ranks
    of ``mesh`` (other processes hold ranks of it; CUDA tensors, one
    shape and dtype): ``op`` ``"gather"`` joins every rank's block along
    ``axis`` in rank order, ``"sum"`` adds them in rank order (float32 or
    bfloat16, each partial sum rounded to the dtype, as ``acc + x`` is).
    Returns the result on this process's device. Counters:
    ``exchange.launches``."""
    if op not in _OPS:
        raise ValueError(f"exchange: unknown op {op!r}")
    b0 = blocks[0]
    dev, shape, dtype = b0.device, tuple(b0.shape), b0.dtype
    if not split(mesh) or len(blocks) != len(mesh.local):
        raise ValueError(f"exchange: {len(blocks)} blocks for a mesh that "
                         f"processes do not split ({mesh})")
    if any(t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
           for t in blocks) or dev.type != "cuda":
        raise ValueError("exchange: the blocks must share one CUDA device, "
                         "shape and dtype")
    if op == "sum" and dtype not in _SUM_DTYPES:
        raise TypeError(f"exchange: sums float32 or bfloat16, got {dtype}")
    xs = [t.contiguous() for t in blocks]
    nd = max(len(shape), 1)
    axis %= nd
    outer = 1
    for k in shape[:axis]:
        outer *= k
    inner = b0.numel() // max(outer, 1)
    W = mesh.size
    out_shape = list(shape) or [1]
    if op == "gather":
        out_shape[axis] *= W
    out = torch.empty(out_shape, dtype=dtype, device=dev)
    if b0.numel() == 0:
        return out
    esz = b0.element_size()
    nbytes = b0.numel() * esz
    lib = _exchange_lib()
    grid = exchange_plan(nbytes, capacity(
        dev, lib.symm_exchange_blocks_per_sm))
    call = communicator(mesh).call(nbytes, grid)
    leaders = sum(1 << r for r in mesh.job_leaders)
    with torch.cuda.device(dev):
        rc = lib.symm_exchange_launch(
            ptrs(xs), ints(list(mesh.local)), len(xs), _OPS[op],
            _SUM_DTYPES.get(dtype, 0), esz, outer, inner, leaders,
            out.data_ptr(), grid, *call.args(0),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "symm_exchange")
    exchange.launches += 1
    return out


exchange.launches = 0
exchange.plain_calls = 0


def every_rank(blocks, mesh) -> list:
    """Every rank's block of the group, rank order, on this process's
    device, from this process's ranks' ``blocks`` (one shape and dtype):
    the blocks themselves where one process holds the group; over
    processes on the card one :func:`exchange` (the blocks stacked), on
    the CPU the gloo link of the mesh's processes."""
    if not split(mesh):
        return list(blocks)
    b0 = blocks[0]
    if b0.device.type == "cuda":
        return list(exchange([t.unsqueeze(0) for t in blocks], mesh,
                             "gather", 0).unbind(0))
    exchange.plain_calls += 1
    parts = mesh.link._all_gather(torch.stack(
        [t.contiguous() for t in blocks]))
    return [t for p in parts for t in p.unbind(0)]


def all_gather(blocks, mesh, axis: int) -> torch.Tensor:
    """Every rank's block joined along ``axis`` in rank order, on this
    process's device (other processes hold ranks of ``mesh``)."""
    if blocks[0].device.type == "cuda":
        return exchange(blocks, mesh, "gather", axis)
    return torch.cat(every_rank(blocks, mesh), dim=axis)


def all_reduce(blocks, mesh) -> torch.Tensor:
    """Every rank's block summed in rank order (``acc + x``), on this
    process's device (other processes hold ranks of ``mesh``)."""
    if blocks[0].device.type == "cuda":
        return exchange(blocks, mesh, "sum")
    acc = None
    for t in every_rank(blocks, mesh):
        acc = t if acc is None else acc + t
    return acc

