"""Ranks and the ambient distribution context (port of
``repro.distributed.context``).

One process drives every rank, as JAX's single controller does: a
``shard_map`` body becomes a loop over ranks. A :class:`Mesh` holds W
ranks, each on a device; several ranks may share one device ("virtual
ranks"), which is how a single card runs the W > 1 protocol.

Two kinds of values cross the distributed sites:

* a **sharded** value is a list of W per-rank tensors, each on its
  rank's device (KV pool shards, attention partials, AG+GEMM shards);
* a **replicated** value is a list with one tensor per *distinct*
  device, shared by the ranks on it (weights, activations, ``cur_len``,
  block tables). Four virtual ranks on one card therefore hold one copy
  of the weights, not four.

Training is the exception: there every value is per rank (parameter
shards and each rank's own copy of a replicated leaf, sequence-sharded
activations), so the same code runs on virtual and on real ranks
(``models.lm.shard_params``).

Model code reads the mesh and the fusion mode from :func:`current`;
launchers install a :class:`DistContext` around their run with
:func:`use`, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.device import resolve_device

FUSION_MODES = ("auto", "bsp", "ring", "pallas")


def canonical_device(device) -> torch.device:
    """``torch.device`` with the CUDA index filled in (``"cuda"`` means
    the current card), so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """W ranks on their devices, rank r on ``devices[r]``."""

    def __init__(self, devices):
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one rank")
        self.devices = devs
        self.distinct = tuple(dict.fromkeys(devs))
        # rank -> index of its device in ``distinct``
        self.dev_index = tuple(self.distinct.index(d) for d in devs)
        # first rank on each distinct device
        self.leaders = tuple(devs.index(d) for d in self.distinct)
        self.symm = None            # kernels.symm.Communicator, on first use

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    def per_rank(self, rep: list) -> list:
        """A replicated value, one entry per rank (ranks on one device
        share the entry)."""
        if len(rep) != len(self.distinct):
            raise ValueError(f"replicated value has {len(rep)} entries for "
                             f"{len(self.distinct)} devices")
        return [rep[i] for i in self.dev_index]

    def from_ranks(self, per_rank: list) -> list:
        """A per-rank value whose ranks agree, as a replicated one: the
        entry of the first rank on each device."""
        return [per_rank[r] for r in self.leaders]


@dataclasses.dataclass
class DistContext:
    """The mesh (``None``: one rank on the caller's device) and the
    fusion mode of the paper's patterns (``core.patterns``)."""
    mesh: Mesh | None = None
    fusion_mode: str = "auto"      # auto | bsp | ring | pallas

    def __post_init__(self):
        if self.fusion_mode not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {self.fusion_mode!r}: "
                             f"expected one of {FUSION_MODES}")

    @property
    def model_axis_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size


def by_device(per_rank: list) -> list:
    """A per-rank value whose ranks agree on each device (replicated
    weights, or what they compute) as a replicated one under the ambient
    mesh: the first rank's entry on each distinct device (the list
    itself at one rank)."""
    mesh = current().mesh
    return per_rank if mesh is None else mesh.from_ranks(per_rank)


_CURRENT: DistContext | None = None


def current() -> DistContext:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = DistContext()
    return _CURRENT


@contextlib.contextmanager
def use(ctx: DistContext):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev
