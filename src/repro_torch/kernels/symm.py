"""Symmetric buffers of a mesh for the fused multi-rank kernels (the
Python half of ``csrc/symm.cuh``).

A :class:`Communicator` belongs to one :class:`Mesh` (``mesh.symm``) and
is shared by the fused AG+GEMM and the two fused flash decodes. Per rank
it holds an inbox (two parities of W source slots) and a flag array (W
sources x ``n_chunk`` words) on the rank's device, plus, on every
distinct device, the device arrays of the W inbox and flag base
addresses that the kernels index. Buffers grow on demand and are never
shrunk; growing waits for every device of the mesh first, since a peer
may still be writing into the old buffers.

Each fused call takes the next epoch (:meth:`Communicator.call`). The
epoch travels as a launch argument: a CUDA graph that captured a call
would replay its epoch, so capturing these kernels needs the epoch in
device memory first.
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
    epoch: int
    slot_bytes: int
    half: int
    n_chunk: int
    W: int
    tables: list          # per distinct device: (inbox_tab, flag_tab)

    def args(self, i: int) -> tuple:
        """The symmetric-buffer arguments of the launch on distinct
        device ``i``, in the order of the kernels' C interfaces."""
        inbox_tab, flag_tab = self.tables[i]
        return (inbox_tab.data_ptr(), flag_tab.data_ptr(), self.W,
                self.n_chunk, self.epoch, self.slot_bytes, self.half)


class Communicator:
    def __init__(self, mesh):
        if any(d.type != "cuda" for d in mesh.devices):
            raise ValueError(f"symmetric buffers need CUDA ranks, got "
                             f"{mesh}")
        self.mesh = mesh
        self.epoch = 0
        self.half = 0          # inbox bytes per parity
        self.n_chunk = 0
        self.inbox: list[torch.Tensor] = []
        self.flags: list[torch.Tensor] = []
        self.tables: list[tuple[torch.Tensor, torch.Tensor]] = []
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
        for d in self.mesh.distinct:
            torch.cuda.synchronize(d)
        W = self.mesh.size
        self.half, self.n_chunk = half, n_chunk
        self.inbox = [torch.empty(2 * half, dtype=torch.uint8, device=d)
                      for d in self.mesh.devices]
        self.flags = [torch.zeros(W * n_chunk, dtype=torch.int32, device=d)
                      for d in self.mesh.devices]
        ib = [t.data_ptr() for t in self.inbox]
        fl = [t.data_ptr() for t in self.flags]
        self.tables = [(torch.tensor(ib, dtype=torch.int64, device=d),
                        torch.tensor(fl, dtype=torch.int64, device=d))
                       for d in self.mesh.distinct]

    def call(self, slot_bytes: int, n_chunk: int) -> Call:
        """Reserve inboxes of W slots of ``slot_bytes`` and ``n_chunk``
        flags per source for one fused launch; returns its epoch and the
        pointer tables."""
        W = self.mesh.size
        slot = _align16(slot_bytes)
        if W * slot > self.half or n_chunk > self.n_chunk:
            self._grow(max(W * slot, self.half), max(n_chunk, self.n_chunk))
        self.epoch += 1
        return Call(self.epoch, slot, self.half, self.n_chunk, W,
                    self.tables)


def communicator(mesh) -> Communicator:
    """The mesh's communicator, created on first use."""
    if mesh is None:
        raise ValueError("a fused multi-rank kernel needs the mesh of its "
                         "ranks (mesh=...)")
    if mesh.symm is None:
        mesh.symm = Communicator(mesh)
    return mesh.symm


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
