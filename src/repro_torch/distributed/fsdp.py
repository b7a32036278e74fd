"""The FSDP gather over the ``data`` axis (ZeRO-3 style), which GSPMD
inserts in JAX where a weight sharded on its ``embed`` / ``in_vocab``
dim over ``data`` meets a product.

Over a (data, model) mesh (``distributed.context``) every rank holds
one block of each such leaf: rank (d, m) block d of the ``data`` dim and
block m of the ``model`` dim (``sharding_rules``). A data group runs
the W-rank model code on whole-``data`` weights, so before a layer runs,
each of its ranks m gathers the D blocks (d', m) of the layer's leaves:
:func:`gather` concatenates them (forward) and splits the gradient back
onto them (backward, autograd's own ``cat``), so each block's ``.grad``
accumulates the sum over the data groups that read it: JAX's
reduce-scatter of the FSDP gradient.

A data group's parameters are :class:`View` trees (:func:`group_views`):
the FSDP leaves as lazy :class:`Shards`, the others the rank's own
tensor. ``models.transformer`` gathers a layer's shards inside the
layer's remat scope (:func:`gathering`), so the backward gathers again
instead of keeping every layer's whole weights alive, as GSPMD does in
JAX's scanned layers; under the ``"dots"`` policy the gather is no
product (``transformer.DOT_OPS``), so it is recomputed too.
``models.lm`` gathers the embedding, the head and the other top-level
leaves once a step.

Over processes (``distributed.processes``) a process holds the blocks
of its own data groups only: :func:`gather` joins those, then the
all-gather over the processes that hold the pod's other groups
(``Mesh.across("data")``) joins the processes' parts in their order,
and its backward reduce-scatters the gradient (the sum over every
process's groups), where in one process autograd's split of the ``cat``
does. Each data group of a process gathers for itself, as in one
process.
"""
from __future__ import annotations

import torch

from repro_torch.core.collective_matmul import nbytes, record, to_device


def gather(blocks: list, dim: int, device, link=None) -> torch.Tensor:
    """The FSDP all-gather: the D ``data`` blocks of one leaf joined
    along ``dim`` on ``device``; the backward splits the gradient and
    moves each block's part back to its device (recorded as JAX's
    all-gather, its backward as the dual reduce-scatter). With ``link``
    (``processes.Link``) ``blocks`` are this process's and the other
    processes' parts join them, in process order."""
    out = torch.cat([to_device(b, device) for b in blocks], dim=dim)
    if link is not None:
        out = link.all_gather(out, dim)
    record("all-gather", nbytes(out), len(blocks) * (
        1 if link is None else len(link)), out=out)
    return out


class Shards:
    """A leaf's D ``data`` blocks (this process's, with ``link`` to the
    others'), to be gathered along ``dim`` on ``device`` where it is
    used; indexing slices every block (a stacked layer leaf's layer
    ``i``)."""

    __slots__ = ("blocks", "dim", "device", "link")

    def __init__(self, blocks: list, dim: int, device, link=None):
        self.blocks, self.dim, self.device = list(blocks), dim, device
        self.link = link

    def __getitem__(self, i: int):
        return Shards([b[i] for b in self.blocks], self.dim - 1, self.device,
                      self.link)

    def gather(self) -> torch.Tensor:
        if self.link is None:
            return gather(self.blocks, self.dim, self.device)
        return gather(self.blocks, self.dim, self.device, self.link)


class View(dict):
    """One rank's parameter tree in a data group: a dict (nested Views)
    whose leaves are tensors or :class:`Shards`, with the rank's
    ``device``, read like an ``lm.LM``."""

    def __init__(self, tree: dict, device):
        super().__init__({k: View(v, device) if isinstance(v, dict)
                          else v for k, v in tree.items()})
        self.device = device


def materialize(tree):
    """``tree`` (a View, a dict, or a list of them) with every
    :class:`Shards` leaf gathered; plain dicts and lists come back."""
    if isinstance(tree, list):
        return [materialize(t) for t in tree]
    if isinstance(tree, Shards):
        return tree.gather()
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    return tree


def gathering(fn):
    """``fn(p, *args)`` with ``p`` (per-rank layer trees) gathered first:
    put inside a remat scope, the gather runs again in the backward."""
    def body(p, *args):
        return fn(materialize(p), *args)
    return body


def is_view(params) -> bool:
    """Whether ``params`` (a per-rank list) holds FSDP views."""
    return bool(params) and isinstance(params[0], View)


def group_views(ranks: list, mesh, g: int, data_dims: dict) -> list:
    """Data group ``g``'s W per-rank :class:`View` trees over ``mesh``
    (``ranks``: one ``lm.LM`` per rank this process holds, row-major):
    model rank m's tree holds, for every leaf ``data_dims`` gives a dim,
    the :class:`Shards` of the D blocks (pod, d', m) of its pod (those
    of other processes through ``mesh.across("data")``), to be gathered
    on its own device, and its own tensor for every other leaf (a copy
    whose gradient ``optim.adamw`` sums over the copies)."""
    W, D = mesh.model, mesh.axis_size("data")
    pod = g // D
    lo = mesh.first
    held = [e for e in range(D) if pod * D + e in mesh.local_groups]
    link = mesh.across("data") if len(held) < D else None
    out = []
    for m in range(W):
        own = ranks[g * W + m - lo]
        peers = [dict(ranks[(pod * D + e) * W + m - lo].named_parameters())
                 for e in held]
        tree: dict = {}
        for name, t in own.named_parameters():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            dim = data_dims[name]
            node[leaf] = t if dim is None else Shards(
                [p[name] for p in peers], dim, own.device, link)
        out.append(View(tree, own.device))
    return out
