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
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build


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
        if self.inbox:
            self.retired.append((self.inbox, self.flags, self.tables))
        W = self.mesh.size
        self.half, self.n_chunk = half, n_chunk
        # zeros: LL lines (csrc/symm.cuh) carry their epoch, and a
        # recycled buffer could hold lines of another mesh's epochs
        self.inbox = [torch.zeros(2 * half, dtype=torch.uint8, device=d)
                      for d in self.mesh.devices]
        self.flags = [torch.zeros(W * n_chunk, dtype=torch.int32, device=d)
                      for d in self.mesh.devices]
        ib = [t.data_ptr() for t in self.inbox]
        fl = [t.data_ptr() for t in self.flags]
        self.tables = [(_upload(ib, d), _upload(fl, d), st)
                       for d, st in zip(self.mesh.distinct, self.state)]

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
