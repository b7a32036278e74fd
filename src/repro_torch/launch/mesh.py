"""Mesh construction for the launchers (port of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` meshes over (possibly fake)
devices; the port's mesh lists a device per rank, and a device may
carry several ranks (virtual ranks). The shapes are JAX's: (data,
model), (pod, data, model) for several pods, and the production meshes
(16, 16) (one pod, 256 ranks) and (2, 16, 16) (two pods, 512 ranks):
DP across pods, FSDP on ``data``, TP/SP/EP on ``model``.

Every builder takes ``procs`` (``distributed.processes.Processes``, or
None for one process): the shape is then the whole job's, its data
groups split over the processes, and ``devices`` (or ``device``) gives
this process's ranks only. A production mesh needs its 16 (32)
processes, one a data group of 16 model ranks.
"""
from __future__ import annotations

from repro_torch.distributed.context import Mesh


def _world(procs) -> int:
    return 1 if procs is None else procs.world


def _device_list(devices, n: int, device: str) -> list:
    """``devices`` (a list, or a comma-separated string of one device per
    rank, ``"cuda:0,cuda:1"``), or ``n`` ranks on ``device``."""
    if devices is None:
        return [device] * n
    if isinstance(devices, str):
        return [d.strip() for d in devices.split(",") if d.strip()]
    return list(devices)


def make_host_mesh(data: int = 1, model: int = 1, devices=None,
                   device: str = "cuda", procs=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every rank of this
    process on ``device``, virtual ranks), JAX's ``make_host_mesh``."""
    devs = _device_list(devices, data * model // _world(procs), device)
    return Mesh(devs, (data, model), ("data", "model"), procs)


def make_mesh_for_devices(n: int, model: int = 16, pods: int = 1,
                          devices=None, device: str = "cuda",
                          procs=None) -> Mesh:
    """JAX's elastic mesh: ``n`` ranks (of every process) as (pods, n /
    (model pods), model), the pod axis only when ``pods`` > 1."""
    if n % (model * pods):
        raise ValueError(f"{n} ranks do not divide into {pods} pod(s) of "
                         f"model={model}")
    data = n // (model * pods)
    devs = _device_list(devices, n // _world(procs), device)
    if pods > 1:
        return Mesh(devs, (pods, data, model), ("pod", "data", "model"),
                    procs)
    return Mesh(devs, (data, model), ("data", "model"), procs)


PRODUCTION_PROCESSES = {False: 16, True: 32}


def make_production_mesh(*, multi_pod: bool = False, devices=None,
                         device: str = "cuda", procs=None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: JAX's production meshes, over
    :data:`PRODUCTION_PROCESSES` processes of one data group (16 model
    ranks) each, as virtual ranks on ``device`` unless ``devices`` lists
    16. Without ``procs`` (one process) it is every rank in this
    process."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for k in shape:
        n *= k
    return Mesh(_device_list(devices, n // _world(procs), device), shape,
                names, procs)


def make_mesh(tp: int, devices=None, device: str = "cuda",
              procs=None, split_model: bool = False) -> Mesh:
    """The launchers' mesh, JAX's ``build_mesh``: n ranks (one per entry
    of ``devices``, a list or a comma-separated string; by default
    ``tp`` ranks on ``device``, virtual ranks) as (data = n // model,
    model = min(tp, n)). ``--devices cpu,cpu,cpu,cpu --tp 2`` is a (2, 2)
    mesh. A count that does not divide by ``tp`` (fewer devices than
    ``tp`` included) raises: JAX's ``n`` is the host's device count,
    the port's is what the caller listed. Over ``procs`` each process
    lists its own ranks, and the mesh is (data = P n // model, model):
    JAX's ``n`` is every device of the job. With ``split_model`` (the
    serving launchers) the processes split the model axis instead: each
    lists its block of the ranks (by default ``tp / P`` on ``device``),
    and the mesh is (data = P n // tp, model = tp)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    world = _world(procs)
    if split_model and world > 1:
        if tp % world and devices is None:
            raise ValueError(f"--tp {tp} does not split over {world} "
                             f"processes")
        devs = _device_list(devices, tp // world, device)
        if not devs or (world * len(devs)) % tp:
            raise ValueError(f"{world} processes of {len(devs)} ranks do "
                             f"not divide by --tp {tp}")
        return make_host_mesh(world * len(devs) // tp, tp, devs,
                              procs=procs)
    devs = _device_list(devices, tp, device)
    if not devs:
        raise ValueError("--devices lists no device")
    model = min(tp, len(devs))
    if len(devs) % tp:
        raise ValueError(f"--devices lists {len(devs)} devices, which do not "
                         f"divide by --tp {tp}: give one device per rank, "
                         f"data x tp of them")
    return make_host_mesh(_world(procs) * len(devs) // model, model, devs,
                          procs=procs)
