"""The trainer over processes, one per block of data groups (torchrun +
``torch.distributed``): the data-axis half of JAX's multi-controller
pod.

JAX's trainer builds its mesh over every device of the job and runs one
controller per host. The port splits a mesh's data groups (its ``(pod,
data)`` coordinates, ``distributed.context``) over P processes: process
p holds the G = dp / P consecutive groups ``[p G, (p + 1) G)``, every
model rank of each, on the devices its own ``--devices`` lists (ranks
keep JAX's row-major numbering, so process p holds ranks ``[p n, (p + 1)
n)``, n = G x model). The ``model`` axis stays inside a process
(virtual ranks, peer pointers, the fused kernels); what crosses
processes is what the trainer sums or gathers over ``data`` and
``pod``, each one ``torch.distributed`` call over the processes that
hold a rank's peers on those axes (:func:`peers`):

* :meth:`Link.all_gather`: the FSDP gather of the blocks other
  processes hold; its backward is the reduce-scatter (each process's
  gradient of the whole weight differs: its own groups' rows);
* :meth:`Link.share`: every process's value, stacked; its backward is
  the process's own slice of the gradient (the identity), since every
  process runs the same function of the stack (the global loss, the
  MoE aux): a sum all-reduce in a fixed order, exact for any layout;
* :meth:`Link.all_reduce`: a sum or max of values no gradient passes
  (the norm's parts, the preemption flag);
* :meth:`Link.gather`: every process's tensor on the first (the
  checkpoint's join).

The backend is explicit: ``nccl`` where each process has cards of its
own, ``gloo`` on the CPU, and ``gloo`` for processes that share a card
only when the caller asks (NCCL refuses two ranks on one device).
Under ``gloo`` a tensor on a card is staged through host memory by this
module, in the open: :attr:`Processes.host_bytes` counts every byte
copied each way.

A process's ranks lie on one device (its card, or the CPU): autograd
runs a device's backward on one thread, so the collectives of the
backward reach the wire in the graph's order on every process.

Serving may also split the ``model`` axis itself (:func:`model_split`):
S processes share one data group, process p holding the W / S
consecutive model ranks ``[p W / S, (p + 1) W / S)``, as JAX drives the
chips of one model axis from several host controllers. What the decode
step gathers or sums over ``model`` then crosses processes: on the card
through the symmetric heap (``kernels.symm``: buffers mapped by CUDA IPC,
the handles exchanged through the job's store, :func:`publish` /
:func:`collect`), device-side, so nothing of a step passes through
``torch.distributed``; on the CPU over the :class:`Link` of the model
peers (``Mesh.link``). Only serving of the attention families splits
it (:func:`check_model_split`); the trainer refuses such a layout
before any parameter is drawn.

Serving's data groups may lie in several processes too (whole groups a
process, or a split model axis on a mesh with several groups): what the
decode step sums or joins over ``data`` and ``pod`` (the weights-
stationary products' partials, the batch rows, the paged pool's
combine over every rank) crosses processes the same way, each
collective over the processes that hold the ranks it spans
(``Mesh.span``), in rank order.
"""
from __future__ import annotations

import os
import socket

import torch

BACKENDS = ("nccl", "gloo")
AXES = ("pod", "data")


# ------------------------------------------------------------ rank maps
def _groups_axes(mesh_shape: dict) -> tuple:
    return (mesh_shape.get("pod", 1), mesh_shape.get("data", 1))


def model_split(mesh_shape: dict, world: int) -> int:
    """S, the processes that share one data group's model ranks: 1 where
    each process holds whole data groups (:func:`check_layout`), else
    ``world / dp`` (more processes than data groups), which must divide
    the model axis."""
    pods, D = _groups_axes(mesh_shape)
    dp, W = pods * D, mesh_shape.get("model", 1)
    if world <= dp:
        return 1
    if world % dp or W % (world // dp):
        raise ValueError(f"{world} processes split neither the {dp} data "
                         f"groups nor the {W} model ranks of each group of "
                         f"mesh {dict(mesh_shape)}")
    return world // dp


def check_layout(mesh_shape: dict, world: int) -> int:
    """The data groups a process holds (G) when ``world`` processes split
    the data groups of a mesh of ``mesh_shape``: they must divide, and
    a process's groups lie in one pod or hold whole pods. 1 where the
    processes split the model axis (a block of one group's model ranks
    a process, :func:`model_split`)."""
    if model_split(mesh_shape, world) > 1:
        return 1
    pods, D = _groups_axes(mesh_shape)
    dp = pods * D
    if world < 1 or dp % world:
        raise ValueError(f"{world} processes do not split the {dp} data "
                         f"groups of mesh {dict(mesh_shape)}")
    G = dp // world
    if D % G and G % D:
        raise ValueError(f"{world} processes of {G} data groups each "
                         f"straddle the pods of {dict(mesh_shape)} "
                         f"(data {D})")
    return G


def process_groups(mesh_shape: dict, world: int, p: int) -> range:
    """The data groups (row-major ``pod x data`` indices) process ``p``
    holds ranks of (its one group where processes split the model
    axis)."""
    S = model_split(mesh_shape, world)
    if S > 1:
        return range(p // S, p // S + 1)
    G = check_layout(mesh_shape, world)
    return range(p * G, (p + 1) * G)


def process_ranks(mesh_shape: dict, world: int, p: int) -> range:
    """The global ranks process ``p`` holds: its groups' model ranks, or
    its block of ``model / S`` of its group's (:func:`model_split`)."""
    W = mesh_shape.get("model", 1)
    S = model_split(mesh_shape, world)
    n = W // S if S > 1 else len(process_groups(mesh_shape, world, p)) * W
    return range(p * n, (p + 1) * n)


def _key(mesh_shape, world, p, axes) -> tuple:
    """Process ``p``'s coordinates along the axes NOT in ``axes``: the
    set of its groups' coordinates along (pod, data), and where the
    processes split the model axis its block of it."""
    _, D = _groups_axes(mesh_shape)
    keep = [a for a in AXES if a not in axes]
    key = tuple(sorted({tuple({"pod": g // D, "data": g % D}[a]
                              for a in keep)
                        for g in process_groups(mesh_shape, world, p)}))
    if "model" in axes:
        return key
    return key, p % model_split(mesh_shape, world)


def peers(mesh_shape: dict, world: int, p: int, axes) -> tuple:
    """The processes (ascending) whose ranks differ from process ``p``'s
    only along ``axes`` (a subset of ``("pod", "data", "model")``): those
    that hold the peers of p's ranks on those axes, p among them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    k = _key(mesh_shape, world, p, axes)
    return tuple(q for q in range(world)
                 if _key(mesh_shape, world, q, axes) == k)


def partition(mesh_shape: dict, world: int, axes) -> list:
    """Every :func:`peers` set of ``axes``, each once, in order."""
    return list(dict.fromkeys(peers(mesh_shape, world, p, axes)
                              for p in range(world)))


# ------------------------------------------------------------ processes
class Processes:
    """This process's place among ``world`` (rank ``rank``) and its
    process groups; :attr:`host_bytes` counts the bytes the ``gloo``
    backend staged between a card and host memory (both ways)."""

    def __init__(self, rank: int, world: int, backend: str | None = None):
        self.rank, self.world, self.backend = rank, world, backend
        self.host_bytes = 0
        self._pg: dict = {}

    def connect(self, mesh_shape: dict):
        """Create the process groups of every :func:`partition` of
        ``mesh_shape`` (on every process, in one order, as
        ``torch.distributed.new_group`` asks)."""
        import torch.distributed as dist
        everyone = tuple(range(self.world))
        for axes in (("data",), ("pod",), AXES, ("model",)):
            for part in partition(mesh_shape, self.world, axes):
                if 1 < len(part) < self.world and part not in self._pg:
                    self._pg[part] = dist.new_group(list(part))
        self._pg[everyone] = None           # the default group

    def link(self, members: tuple) -> "Link":
        if members not in self._pg:
            raise RuntimeError(f"no process group for {members}: "
                               f"Processes.connect(mesh.shape) first")
        return Link(self, members, self._pg[members])

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend reads it: host memory under gloo (page-
        locked, from the caching host allocator)."""
        if self.backend == "gloo" and x.device.type != "cpu":
            self.host_bytes += x.numel() * x.element_size()
            return _host(x.shape, x.dtype, True).copy_(x)
        return x.contiguous()

    def _back(self, x: torch.Tensor, dev) -> torch.Tensor:
        if x.device != dev:
            self.host_bytes += x.numel() * x.element_size()
            return x.to(dev)
        return x


def _host(shape, dtype, pinned: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


class Link:
    """The collectives over ``members`` (process ranks, ascending)."""

    def __init__(self, procs: Processes, members: tuple, pg):
        self.procs, self.members, self.pg = procs, members, pg
        self.index = members.index(procs.rank)

    def __len__(self):
        return len(self.members)

    def _all_gather(self, x: torch.Tensor) -> list:
        import torch.distributed as dist
        xs = self.procs._stage(x)
        out = [_host(xs.shape, xs.dtype, xs.is_pinned())
               if xs.device.type == "cpu" else torch.empty_like(xs)
               for _ in self.members]
        dist.all_gather(out, xs, group=self.pg)
        return [self.procs._back(t, x.device) for t in out]

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' ``x`` joined along ``dim`` in member order;
        the backward reduce-scatters (sums every member's gradient and
        hands each its block)."""
        return _AllGather.apply(x, dim, self)

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """The members' ``x`` stacked on a new dim 0, the same on every
        member; the backward takes this member's slice (every member
        runs the same function of the stack)."""
        if not x.requires_grad:
            return torch.stack(self._all_gather(x.detach()))
        return _Share.apply(x, self)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The members' ``x`` summed (or their max), no gradient."""
        import torch.distributed as dist
        xs = self.procs._stage(x.detach()).clone()
        dist.all_reduce(xs, op={"sum": dist.ReduceOp.SUM,
                                "max": dist.ReduceOp.MAX}[op], group=self.pg)
        return self.procs._back(xs, x.device)

    def gather(self, x: torch.Tensor) -> list | None:
        """Every member's ``x`` (host memory) on the first member, in
        member order; None on the others."""
        import torch.distributed as dist
        xs = self.procs._stage(x.detach())
        first = self.members[0]
        out = ([torch.empty_like(xs) for _ in self.members]
               if self.procs.rank == first else None)
        dist.gather(xs, out, dst=first, group=self.pg)
        return None if out is None else [t.cpu() for t in out]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, link):
        ctx.dim, ctx.link = dim, link
        return torch.cat(link._all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        link = ctx.link
        parts = [link.procs._stage(c) for c in
                 grad.chunk(len(link), dim=ctx.dim)]
        p0 = parts[0]
        out = _host(p0.shape, p0.dtype, p0.is_pinned()) \
            if p0.device.type == "cpu" else torch.empty_like(p0)
        dist.reduce_scatter(out, parts, group=link.pg)
        return link.procs._back(out, grad.device), None, None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, link):
        ctx.link = link
        return torch.stack(link._all_gather(x))

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.link.index], None


# ------------------------------------------------------------------ init
def backend_for(device_type: str, backend: str | None) -> str:
    """``backend``, or the one a process on ``device_type`` takes by
    default: nccl on a card, gloo on the CPU."""
    if backend is None:
        return "nccl" if device_type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs on cards: --dist-backend "
                         "gloo on the CPU")
    return backend


_PROCS: Processes | None = None


def current() -> Processes | None:
    """This process's :class:`Processes` when ``torch.distributed`` is
    initialized over more than one process, else None."""
    global _PROCS
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return None
    if _PROCS is None or _PROCS.rank != dist.get_rank():
        _PROCS = Processes(dist.get_rank(), dist.get_world_size(),
                           dist.get_backend())
    return _PROCS


def init(backend: str | None = None, device_type: str = "cuda", *,
         init_method: str | None = None, rank: int | None = None,
         world_size: int | None = None) -> Processes | None:
    """Join the job: from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or from an explicit
    ``init_method``, ``rank`` and ``world_size``. Returns None for a job
    of one process (nothing is initialized), the current
    :class:`Processes` where ``torch.distributed`` is up already."""
    import torch.distributed as dist
    have = current()
    if have is not None:
        return have
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    if world_size == 1:
        return None
    backend = backend_for(device_type, backend)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return current()


def shutdown():
    """Leave the job (after :func:`init`)."""
    global _PROCS
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _PROCS = None


def _store():
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def publish(procs: Processes, key: str, value: bytes):
    """Put this process's ``value`` under ``key`` in the job's store."""
    _store().set(f"repro_torch/{key}/{procs.rank}", value)


def collect(procs: Processes, key: str, members) -> list:
    """Every member's value under ``key`` (:func:`publish`), in member
    order; waits for each (the store's timeout ends a missing one)."""
    store = _store()
    return [store.get(f"repro_torch/{key}/{q}") for q in members]


def barrier(procs: Processes, key: str, members):
    """Wait until every member has reached ``key``."""
    publish(procs, key, b"1")
    collect(procs, key, members)


def align(mesh, what: str):
    """Where other processes hold ranks of ``mesh`` (``Mesh.spans``),
    wait until every one of them has reached this call (each makes the
    same calls, so the n-th of each meets the n-th of the others): a
    cross-process kernel's wait for its peers is bounded
    (``csrc/symm.cuh``, SPIN_NS), so none must start while a peer is
    still busy on its host (building an engine, capturing a graph)."""
    if mesh is None or not mesh.spans:
        return
    _ALIGNED[0] += 1
    barrier(mesh.procs, f"aligned/{what}/{_ALIGNED[0]}", mesh.peers)


_ALIGNED = [0]              # align() calls made so far (store keys)
_AGREED: dict = {}          # key -> agreements made under it so far


def agree(procs: Processes, key: str, value: bytes, members, what: str):
    """Raise unless every member put the same ``value`` under ``key``
    (the end of a run: what each process computed must be one). Each
    call takes a fresh key (``key`` and a count of the calls made under
    it, the same in every process), so a later agreement never reads an
    earlier one's values."""
    _AGREED[key] = n = _AGREED.get(key, 0) + 1
    key = f"{key}/{n}"
    publish(procs, key, value)
    got = collect(procs, key, members)
    differ = [q for q, v in zip(members, got) if v != value]
    if differ:
        raise RuntimeError(f"process {procs.rank}'s {what} differ from "
                           f"those of processes {differ}")


# where the model axis over processes goes next (ROADMAP queue 1)
NEXT = {"train": "ROADMAP queue 1, item 1b: the trainer with the model "
                 "axis over processes",
        "family": "ROADMAP queue 1, item 1d: the recurrent, hybrid and "
                  "vlm families with the model axis over processes"}
# the families whose decode step crosses processes on the model axis
SPLIT_BLOCKS = ("attn_mlp", "attn_moe")
SPLIT_FAMILIES = ("dense", "moe")
# the most ranks one collective spans over processes when serving: the
# exchange and the fused kernels take a 32-bit mask of ranks
# (csrc/symm_exchange.cu, csrc/ag_gemm.cu), and the paged pool's combine
# spans the whole mesh
MAX_SPAN = 32


def check_model_split(mesh_shape: dict, world: int, *, what: str,
                      cfg=None):
    """Refuse a layout over ``world`` processes where ``what`` cannot run
    on it: ``"train"`` (the trainer) over processes that split the model
    axis (:func:`model_split`); ``"serve"`` over a mesh of more than
    :data:`MAX_SPAN` ranks (its collectives span up to the whole mesh),
    or with a family outside :data:`SPLIT_FAMILIES` (``cfg``) over a
    split model axis. Called before any parameter is drawn; data groups
    over processes pass, with or without a split model axis."""
    S = model_split(mesh_shape, world)
    layout = (f"{world} processes splitting the model axis of mesh "
              f"{dict(mesh_shape)}")
    if what == "train":
        if S > 1:
            raise NotImplementedError(f"training over {layout}: not yet "
                                      f"({NEXT['train']})")
        return
    n = 1
    for k in mesh_shape.values():
        n *= k
    if world > 1 and n > MAX_SPAN:
        raise ValueError(
            f"serving mesh {dict(mesh_shape)} over {world} processes: its "
            f"{n} ranks exceed MAX_SPAN={MAX_SPAN}, the most one "
            f"collective spans across processes (the exchange and the "
            f"fused kernels take a 32-bit mask of ranks)")
    if S > 1 and cfg is not None and (cfg.family not in SPLIT_FAMILIES
                                      or cfg.block not in SPLIT_BLOCKS):
        raise NotImplementedError(f"serving {cfg.name} ({cfg.family}) over "
                                  f"{layout}: not yet ({NEXT['family']})")


def check_cards(procs: Processes, devices):
    """Under nccl, refuse processes that share a card (NCCL refuses two
    ranks on one device): each process's cards go through the job's
    store, so this raises on every process before any parameter is
    drawn or any NCCL communicator made."""
    if procs.backend != "nccl":
        return
    import torch.distributed as dist
    host = socket.gethostname()
    mine = sorted({f"{host}/{torch.cuda.get_device_properties(d).uuid}"
                   for d in devices})
    store = dist.distributed_c10d._get_default_store()
    store.set(f"repro_torch/cards/{procs.rank}", ",".join(mine))
    seen: dict = {}
    for q in range(procs.world):
        for card in store.get(f"repro_torch/cards/{q}").decode().split(","):
            seen.setdefault(card, []).append(q)
    shared = {c: qs for c, qs in seen.items() if len(qs) > 1}
    if shared:
        raise RuntimeError(
            f"processes {sorted({q for qs in shared.values() for q in qs})} "
            f"share a card under nccl, which refuses two ranks on one "
            f"device: give each process cards of its own, or pass "
            f"--dist-backend gloo (collectives staged through host "
            f"memory)")
