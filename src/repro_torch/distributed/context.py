"""Ranks and the ambient distribution context (port of
``repro.distributed.context``).

One process drives every rank, as JAX's single controller does: a
``shard_map`` body becomes a loop over ranks. A :class:`Mesh` holds its
ranks, each on a device; several ranks may share one device ("virtual
ranks"), which is how a single card runs the W > 1 protocol. Its named
axes are ``("model",)``, ``("data", "model")`` or ``("pod", "data",
"model")``, the ranks numbered row-major over them as ``jax.make_mesh``
orders its devices. The ``model`` axis is the last: the W ranks of one
data group (one (pod, data) coordinate) are consecutive, and
:meth:`Mesh.group` is their model-only sub-mesh, the mesh that the
model-axis collectives (``core.collective_matmul``, ``core.patterns``,
``kernels.symm``) run over. At ``data = 1`` the mesh is its own group.

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

The trainer may also run as several processes (torchrun), each holding
whole data groups of one global mesh (``distributed.processes``): a
:class:`Mesh` with ``procs`` keeps the global shape, coordinates and
groups, and lists the devices of its process's ranks only
(:attr:`Mesh.local`); per-rank values hold those ranks, and
:meth:`Mesh.across` is the link to the processes that hold their peers
along the data axes. Serving may split the ``model`` axis too
(:attr:`Mesh.split` processes a data group, each a block of its model
ranks): ``size``, ``shape`` and ``model`` stay the job's, while
``devices``, ``distinct``, ``leaders``, ``per_rank`` / ``from_ranks``
and the per-rank lists are this process's ranks' (list index i is
global rank ``first + i``). A collective over some of the job's ranks
(a data group's model ranks, a model rank's data peers, the whole
mesh) runs on :meth:`Mesh.span`, a one-axis mesh of those ranks whose
``local`` are the members this process holds (:attr:`Mesh.spans` where
other processes hold the rest); its collectives cross processes
(``kernels.symm``: :func:`~repro_torch.kernels.symm.every_rank`), each
span with its own communicator.

Model code reads the mesh and the fusion mode from :func:`current`;
launchers install a :class:`DistContext` around their run with
:func:`use`, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import processes
from repro_torch.kernels.symm import check_virtual_ranks

FUSION_MODES = ("auto", "bsp", "ring", "pallas")


def canonical_device(device) -> torch.device:
    """``torch.device`` with the CUDA index filled in (``"cuda"`` means
    the current card), so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


AXES = ("pod", "data", "model")


class Mesh:
    """Ranks on their devices, rank r on ``devices[r]``, over the named
    axes ``axis_names`` of sizes ``axis_shape`` (default: one ``model``
    axis of every rank); ``shape`` maps each axis to its size, as a JAX
    mesh's does. With ``procs`` (``processes.Processes``) the shape is
    the whole job's and ``devices`` lists this process's ranks, rank r
    on ``devices[r - first]`` for r in :attr:`local`."""

    def __init__(self, devices, axis_shape=None, axis_names=None,
                 procs=None, *, local=None, peers=None):
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one rank")
        world = 1 if procs is None else procs.world
        if axis_shape is None:
            axis_shape = (len(devs) * world,)
        axis_shape = tuple(int(n) for n in axis_shape)
        if axis_names is None:
            axis_names = AXES[len(AXES) - len(axis_shape):]
        axis_names = tuple(axis_names)
        if (len(axis_names) != len(axis_shape) or axis_names[-1] != "model"
                or axis_names != tuple(a for a in AXES if a in axis_names)):
            raise ValueError(f"mesh axes {axis_names} of shape {axis_shape}: "
                             f"expected axes of {AXES} in that order, the "
                             f"last 'model'")
        n = 1
        for k in axis_shape:
            n *= k
        if (local is None and n != len(devs) * world) \
                or (local is not None and len(local) != len(devs)):
            raise ValueError(f"mesh shape {axis_shape} holds {n} ranks, "
                             f"{len(devs)} devices given"
                             + (f" to each of {world} processes"
                                if world > 1 else ""))
        check_virtual_ranks(devs)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_shape))
        self._groups: dict = {}
        self.procs = procs
        # the ranks this process holds (every rank in one process), and
        # the processes that hold ranks of this mesh (None: this one)
        if local is not None:
            self.local, self.peers = local, tuple(peers)
        elif procs is None:
            self.local, self.peers = range(0, n), None
        else:
            self.local = processes.process_ranks(self.shape, world,
                                                 procs.rank)
            self.peers = tuple(range(world))
        # the job's ranks of this mesh, in its order (a span's members)
        self.ranks = tuple(range(n))
        if procs is not None and len(set(devs)) > 1:
            raise NotImplementedError(
                f"a process's ranks on several devices ({list(devs)}) over "
                f"processes: autograd runs each device's backward on a "
                f"thread of its own, which would put the cross-process "
                f"collectives on the wire in an order that differs "
                f"between processes; list one device per process "
                f"(ROADMAP queue 1)")
        self.devices = devs
        self.distinct = tuple(dict.fromkeys(devs))
        # rank -> index of its device in ``distinct``
        self.dev_index = tuple(self.distinct.index(d) for d in devs)
        # first rank on each distinct device
        self.leaders = tuple(devs.index(d) for d in self.distinct)
        # processes that share a data group's model ranks (1: none); of
        # a span, the processes that share it
        self.split = 1 if procs is None else (
            len(self.peers) if local is not None
            else processes.model_split(self.shape, world))
        self.symm = None            # kernels.symm.Communicator, on first use
        self._link = None

    @property
    def spans(self) -> bool:
        """Whether other processes hold ranks of this mesh (its per-rank
        lists then hold this process's ranks, :attr:`local`)."""
        return self.peers is not None and len(self.peers) > 1

    @property
    def job_leaders(self) -> tuple:
        """The rank of the first rank on each device of this mesh, in
        every process that holds ranks of it (a fused kernel pushes into
        their inboxes; :attr:`leaders` where one process holds them
        all). Each process holds as many consecutive ranks."""
        if not self.spans:
            return tuple(self.first + i for i in self.leaders)
        n = len(self.local)
        return tuple(q * n + i for q in range(len(self.peers))
                     for i in self.leaders)

    @property
    def link(self):
        """The :class:`processes.Link` to the processes that hold ranks
        of this mesh (:attr:`spans`), made once."""
        if self._link is None:
            self._link = self.procs.link(self.peers)
        return self._link

    def span(self, ranks) -> "Mesh":
        """The one-axis mesh over ``ranks`` (the job's ranks of this
        mesh, ascending: the ranks one collective spans), the same object
        on every call: a mesh of its devices where this process holds
        every one, else a mesh over processes whose :attr:`local` are
        the members this process holds (each process as many, in a
        block, processes in rank order). Its ``symm`` communicator and
        its link are its own; the mesh itself over all its ranks."""
        ranks = tuple(ranks)
        if ranks == self.ranks:
            return self
        if ranks not in self._groups:
            here = [i for i, r in enumerate(ranks) if r in self.local]
            if not here:
                raise ValueError(f"ranks {list(ranks)} lie in other "
                                 f"processes")
            devs = [self.devices[ranks[i] - self.first] for i in here]
            if len(here) == len(ranks):
                sub = Mesh(devs)
            else:
                n = len(self.local)
                peers = tuple(sorted({r // n for r in ranks}))
                if here != list(range(here[0], here[0] + len(here))) \
                        or len(ranks) != len(peers) * len(here):
                    raise ValueError(f"ranks {list(ranks)}: each process "
                                     f"must hold a block of as many")
                sub = Mesh(devs, (len(ranks),), ("model",), self.procs,
                           local=range(here[0], here[-1] + 1), peers=peers)
            sub.ranks = ranks
            self._groups[ranks] = sub
        return self._groups[ranks]

    def axis_span(self, rank: int, axes) -> "Mesh":
        """:meth:`span` over the ranks that differ from ``rank`` only
        along ``axes`` (its peers on those axes, rank r of the span the
        r-th of them in row-major order)."""
        for g in self.axis_groups(axes):
            if rank in g:
                return self.span(g)
        raise ValueError(f"rank {rank} is not in mesh {self}")

    @property
    def heap_bytes(self) -> int:
        """The symmetric heap this process allocated for this mesh and
        its spans (``kernels.symm``; 0 in one process)."""
        return sum(m.symm.heap_bytes for m in (self, *self._groups.values())
                   if m.symm is not None)

    def close(self):
        """Release the symmetric buffers of this mesh and of its spans
        (``kernels.symm.close``); after the last launch that uses them."""
        from repro_torch.kernels import symm
        symm.close([m.symm for m in (self, *self._groups.values())
                    if m.symm is not None], self)

    @property
    def size(self) -> int:
        """Every rank of the mesh, in every process (the model width is
        ``shape["model"]``)."""
        n = 1
        for k in self.shape.values():
            n *= k
        return n

    @property
    def first(self) -> int:
        """The global rank of this process's first rank."""
        return self.local.start

    @property
    def local_groups(self) -> range:
        """The data groups this process holds (every one in one
        process)."""
        return range(self.local.start // self.model,
                     -(-self.local.stop // self.model))

    @property
    def rank_devices(self) -> tuple:
        """A device for every rank of the mesh, None for the ranks other
        processes hold."""
        return ((None,) * self.first + self.devices
                + (None,) * (self.size - self.local.stop))

    def across(self, axes):
        """The :class:`processes.Link` to the processes that hold the
        peers of this process's ranks along ``axes`` (of ``("pod",
        "data")``), or None where this process holds them all."""
        if self.procs is None:
            return None
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        members = processes.peers(self.shape, self.procs.world,
                                  self.procs.rank, axes)
        return None if len(members) == 1 else self.procs.link(members)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def model(self) -> int:
        return self.shape["model"]

    @property
    def dp(self) -> int:
        """The data groups: the product of the ``pod`` and ``data``
        sizes, JAX's ``batch`` axes."""
        return self.size // self.model

    def coords(self, r: int) -> dict:
        """Rank ``r``'s coordinate on every axis (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            r, out[a] = divmod(r, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def axis_groups(self, axis) -> list:
        """The ranks that differ only along ``axis`` (a name, or a tuple
        of names), one list a group, each in row-major order (JAX's
        ``psum`` groups)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        out: dict = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(r)
        return list(out.values())

    def group(self, g: int) -> "Mesh":
        """Data group ``g``'s model-only sub-mesh (its ranks ``g W ..
        g W + W - 1``; :meth:`span`), the same object on every call (it
        keeps its ``symm`` communicator); the mesh itself when ``dp`` is
        1."""
        if self.dp == 1:
            return self
        if g not in self.local_groups:
            raise ValueError(f"data group {g} lies in another process")
        W = self.model
        return self.span(range(g * W, (g + 1) * W))

    @functools.cached_property
    def holders(self) -> list:
        """(data group, device) of every copy of a value the ranks of a
        data group share (the decode step's recurrent state, ``models.lm``):
        each group's distinct devices, this process's groups in order; on
        a model-only mesh its distinct devices."""
        return [(g, d) for g in self.local_groups
                for d in self.group(g).distinct]

    def rows(self, g: int, batch: int) -> slice:
        """Data group ``g``'s rows of a batch of ``batch`` slots: JAX's
        ``batch_spec`` (``sharding_rules``), ``batch / dp`` consecutive
        rows where it divides, else every row (each group holds the whole
        batch)."""
        if batch % self.dp:
            return slice(0, batch)
        b = batch // self.dp
        return slice(g * b, (g + 1) * b)

    def __repr__(self):
        if self.axis_names == ("model",):
            return f"Mesh({[str(d) for d in self.devices]})"
        where = "" if self.procs is None else \
            f", process {self.procs.rank} of {self.procs.world}"
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{dict(self.shape)}{where})")

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
    fusion mode of the paper's patterns (``core.patterns``). ``data``:
    inside a decode step on a mesh with data groups, that mesh, while
    ``mesh`` is the model sub-mesh of this process's first data group
    (``Mesh.group``; None at one model rank) that the weight sites run
    on (``models.lm``)."""
    mesh: Mesh | None = None
    fusion_mode: str = "auto"      # auto | bsp | ring | pallas
    data: Mesh | None = None

    def __post_init__(self):
        if self.fusion_mode not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {self.fusion_mode!r}: "
                             f"expected one of {FUSION_MODES}")

    @property
    def model_axis_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.model


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
