"""Mesh construction for the launchers (port of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` meshes over (possibly fake)
devices; the port's mesh lists a device per rank, and a device may
carry several ranks (virtual ranks).
"""
from __future__ import annotations

from repro_torch.distributed.context import Mesh


def make_mesh(tp: int, devices=None, device: str = "cuda") -> Mesh:
    """A mesh of ``tp`` ranks. ``devices`` is a list or a comma-separated
    string of one device per rank (``"cuda:0,cuda:1"``); by default all
    ranks share ``device`` (virtual ranks)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        devs = [device] * tp
    else:
        devs = ([d.strip() for d in devices.split(",") if d.strip()]
                if isinstance(devices, str) else list(devices))
    if len(devs) != tp:
        raise ValueError(f"--devices lists {len(devs)} devices for "
                         f"--tp {tp}: give one device per rank")
    return Mesh(devs)
