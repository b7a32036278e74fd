"""Async, atomic checkpointing of tensor trees (the port's counterpart of
``repro.checkpoint.checkpointer``, with the same on-disk contract and no
JAX).

Layout: ``<dir>/step_<N>/`` holds ``shard_0.npz`` (the flattened leaves)
and ``manifest.json`` (step, time, leaf count, the caller's ``extra``,
and the dtype of every leaf that numpy cannot hold). A checkpoint is
written under a ``.tmp_*`` name and committed by ``os.rename``, so a
crash mid-write never leaves a partial step behind; ``step_<N>``
without a manifest does not count. At most one save is in flight: it
snapshots the leaves to host memory on the caller's thread and writes on
a background thread. ``keep`` bounds how many steps stay on disk.

A tree is nested dicts and lists of tensors or numpy arrays; a leaf's
key is its path joined by ``%%`` (dict keys, list indices), as the JAX
checkpointer writes them, so this module reads the JAX package's
checkpoints too.

bfloat16, which numpy lacks, is stored exactly as its uint16 bits with
``"bfloat16"`` under the leaf's key in the manifest's ``dtypes``; a
leaf that npz returns as raw void of itemsize 2 (what the JAX
checkpointer writes for a bf16 array) is read as bf16 bits too.

:meth:`Checkpointer.restore` copies each leaf IN PLACE into the
template's tensors (``copy_``), so tensors that something else holds by
address (a captured CUDA graph) see the restored values.

Sharded state (the ranks of a mesh, each holding blocks of some
leaves, cut over the ``model`` and ``data`` axes by the sharding rules)
is saved as the global arrays (:meth:`Checkpointer.save_sharded`: the
blocks joined by each leaf's spec, ``distributed.sharding_rules.join``),
so the file is the one a single rank or the JAX checkpointer writes;
:meth:`Checkpointer.restore_sharded` reads it onto any mesh, any (data,
model) (JAX's elastic restore). Over processes (``distributed.processes``:
each holds its own ranks' blocks) the first process joins and writes,
the others send it their blocks a leaf at a time; a restore reads each
process's own ranks' blocks, so a checkpoint of any mesh, in one
process or many (or JAX's), resumes on any process layout.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.distributed.sharding_rules import (cut, join, n_blocks,
                                                    rank_coords, spec_shape)

SEP = "%%"
BF16 = "bfloat16"


def flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a nested dict/list tree, paths joined by SEP."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict) -> dict:
    """Nested dicts from ``{path: leaf}`` (every level a dict)."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _to_host(leaf) -> tuple[np.ndarray, str | None]:
    """A private host copy of ``leaf`` and its dtype name when numpy
    cannot hold it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), None
    return np.array(leaf, copy=True), None


def _is_bf16_bits(dt: np.dtype, dtype: str | None) -> bool:
    return dtype == BF16 or (dt.kind == "V" and dt.itemsize == 2)


def _to_tensor(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])   # keeps 0-d arrays
    if _is_bf16_bits(arr.dtype, dtype):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _header(z, key: str, dtype: str | None) -> tuple[tuple, torch.dtype]:
    """(shape, torch dtype) of the member ``key`` of the open npz ``z``,
    read from the member's header alone."""
    fmt = np.lib.format
    with z.zip.open(key + ".npy") as f:
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, _, dt = read(f)
    if _is_bf16_bits(dt, dtype):
        return tuple(shape), torch.bfloat16
    return tuple(shape), torch.from_numpy(np.empty(0, dt)).dtype


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None,
             block: bool = False):
        """Snapshot ``tree`` to host memory, then write it (on a
        background thread unless ``block`` or ``async_save=False``)."""
        self.save_sharded(step, [tree], {}, extra, block)

    def save_sharded(self, step: int, trees: list, dims: dict,
                     extra: dict | None = None, block: bool = False,
                     mesh_shape: dict | None = None, link=None):
        """:meth:`save` of the global tree of per-rank ``trees`` (ranks
        row-major over ``mesh_shape``'s axes; default one ``model`` axis
        of every rank): the leaf at key k is joined from the ranks'
        blocks by its spec ``dims[k]`` (one entry a dim: None, or the
        mesh axes that cut it; ``sharding_rules.join``), or taken from
        rank 0 where ``dims`` has none (a replicated leaf). The join runs
        on the host. With ``link`` (``processes.Link`` over every
        process, ``Mesh.across``) ``trees`` are this process's ranks,
        the processes' in order make every rank's, and the first process
        joins (each leaf's blocks gathered to it) and writes; the others
        write nothing."""
        self.wait()   # one in-flight save at a time
        flats = [flatten(t) for t in trees]
        shape = _mesh_shape(mesh_shape, len(trees) * (
            1 if link is None else len(link)))
        first = link is None or link.index == 0
        joined = {}
        for key in sorted(flats[0]):
            d = dims.get(key)
            if not d:
                joined[key] = flats[0][key]
                continue
            if link is None:
                blocks = [f[key].detach().cpu() for f in flats]
            else:           # this process's ranks lie on one device
                every = link.gather(torch.stack([f[key].detach()
                                                 for f in flats]))
                blocks = None if every is None else [
                    b for part in every for b in part]
            if first:
                joined[key] = join(blocks, d, shape)
        if first:
            self._save_flat(step, {k: joined[k] for k in flats[0]}, extra,
                            block)

    def _save_flat(self, step, leaves: dict, extra, block):
        flat, dtypes = {}, {}
        for key, leaf in leaves.items():
            flat[key], dt = _to_host(leaf)
            if dt is not None:
                dtypes[key] = dt
        extra = dict(extra or {})

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
            manifest = {"step": step, "time": time.time(),
                        "n_leaves": len(flat), "dtypes": dtypes,
                        "extra": extra}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic commit
            self._gc()

        if self.async_save and not block:
            def _bg():
                try:
                    _write()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_bg, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        """Join the save in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int | None) -> str:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return os.path.join(self.dir, f"step_{step:08d}")

    def manifest(self, step: int | None = None) -> dict:
        """The manifest of ``step`` (default: the latest)."""
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)

    def read(self, step: int | None = None) -> tuple[dict, dict]:
        """``({path: tensor on the CPU}, manifest)`` of ``step`` (default:
        the latest), bf16 leaves as bf16 tensors."""
        path = self._path(step)
        manifest = self.manifest(step)
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            flat = {k: _to_tensor(z[k], dtypes.get(k)) for k in z.files}
        return flat, manifest

    def restore(self, step: int | None, template):
        """Copy ``step`` (default: the latest) into ``template``'s
        tensors in place; raises on a missing leaf or a shape or dtype
        mismatch before it writes anything. Returns (template,
        manifest)."""
        (template,), manifest = self.restore_sharded(step, [template], {})
        return template, manifest

    def restore_sharded(self, step: int | None, templates: list,
                        dims: dict, mesh_shape: dict | None = None,
                        cast: bool = False, first: int = 0):
        """:meth:`restore` onto the ranks of a mesh (row-major over
        ``mesh_shape``'s axes; default one ``model`` axis of every
        rank): each rank's template takes its block (``sharding_rules.cut``
        by the spec ``dims[k]``) of the leaf at key k, or the whole leaf
        where ``dims`` has none. Any mesh whose blocks divide the saved
        leaves reads any checkpoint. The file is read one member at a
        time (the headers first, so a missing leaf or a shape or dtype
        mismatch raises before anything is written), so the host holds
        one leaf, never the whole tree. A leaf's dtype must be the
        template's, unless ``cast``: then each rank's block is cast to
        its template's dtype after the cut (serving restores fp32
        masters, or bf16 leaves, into its storage dtypes). ``first``: the
        global rank of the first template (a process's ranks of a mesh
        over processes, ``Mesh.first``). Returns (templates,
        manifest)."""
        path = self._path(step)
        manifest = self.manifest(step)
        dtypes = manifest.get("dtypes", {})
        shape = _mesh_shape(mesh_shape, len(templates))
        coords = rank_coords(shape)[first:]
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            heads = {k: _header(z, k, dtypes.get(k)) for k in z.files}
            plan: dict = {}
            for r, template in enumerate(templates):
                for key, dst in flatten(template).items():
                    if key not in heads:
                        raise KeyError(f"checkpoint missing leaf {key}")
                    (got, dt), d = heads[key], dims.get(key)
                    if d:
                        for i, p in enumerate(d):
                            if got[i] % n_blocks(p, shape):
                                raise ValueError(
                                    f"checkpoint leaf {key}: dim {i} of "
                                    f"{got} does not split over "
                                    f"mesh {dict(shape)} as {d}")
                        got = spec_shape(got, d, shape)
                    if got != tuple(dst.shape) or (dt != dst.dtype
                                                   and not cast):
                        raise ValueError(
                            f"checkpoint leaf {key}: {dt} {got} != "
                            f"template {dst.dtype} {tuple(dst.shape)}")
                    plan.setdefault(key, []).append((dst, coords[r], d))
            with torch.no_grad():
                for key, dsts in plan.items():
                    leaf = _to_tensor(z[key], dtypes.get(key))
                    for dst, c, d in dsts:
                        block = cut(leaf, d, c, shape) if d else leaf
                        dst.copy_(block.to(dst.dtype) if cast else block)
                    del leaf
        return templates, manifest


def _mesh_shape(mesh_shape, n: int) -> dict:
    return {"model": n} if mesh_shape is None else dict(mesh_shape)
