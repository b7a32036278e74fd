"""AdamW with global-norm clipping over nested dicts of tensors (port of
``repro.optim.adamw``).

Where JAX returns new trees, :func:`apply_updates` updates the
parameters and the moments IN PLACE under ``torch.no_grad`` (the
training state is 16 bytes a parameter: fp32 master, gradient, ``m``
and ``v``; a second copy would not fit a card at full width). The
float32 arithmetic follows JAX's step for step: ``step = state["step"]
+ 1``, the clip ``min(1, clip / max(gnorm, 1e-9))``, the bias
corrections ``1 - b ** step`` in float32, and weight decay skipped for
every leaf whose ``/``-joined path contains a ``no_decay`` substring
(so ``backbone/layers/mlp/wu``, which contains ``"u"``, gets none, as in
JAX).

Over the ranks of a mesh, :func:`apply_updates_ranks` takes per-rank
trees of shards (``lm.shard_params``) and each leaf's spec over the
mesh's axes (``lm.leaf_specs``): the gradients of the ranks that hold
the same block of a leaf (its copies: over ``data`` for a leaf that
only ``model`` cuts, over every rank for a replicated one, over none
for one both axes cut) are summed first, the global norm counts each
distinct block once, and every rank then takes JAX's step on its
blocks with the one clip, so the copies stay bit-identical.

Over processes (``distributed.processes``; ``mesh`` with ``procs``)
each process passes the trees of its own ranks: a copy group that
spans processes shares its members' gradients over the processes that
hold them (``Mesh.across``) and sums them in rank order, and each
distinct block's square sum comes from the process of its first rank
(one sum over the processes, every other entry 0), so every process
takes the same norm, the same bits as in one process.

A gradient leaf may be ``None``: a parameter the loss never reads (an
audio model's input table: JAX's ``value_and_grad`` gives it zeros)
takes a zero gradient, so its moments and its weight decay move as in
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.collective_matmul import to_device
from repro_torch.distributed.sharding_rules import rank_coords
from repro_torch.models.module import tree_items


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # names containing these substrings get no weight decay
    no_decay: tuple[str, ...] = ("scale", "bias", "A_log", "dt_bias", "mu_",
                                 "w0", "u")


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v, dtype=torch.float32)
            for k, v in tree.items()}


def init_state(params: dict) -> dict:
    """fp32 ``m`` and ``v`` shaped like ``params`` and an int32 0-d step
    counter, on the parameters' device."""
    dev = next(t for _, t in tree_items(params)).device
    return {"m": _zeros_like(params), "v": _zeros_like(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted-key order, as JAX's) of
    each one's sum of squares, in float32."""
    sq = [x.float().square().sum() for _, x in tree_items(tree)]
    return torch.stack(sq).sum().sqrt()


def _path(dotted: str) -> str:
    return dotted.replace(".", "/")


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> dict:
    """One AdamW step, IN PLACE on ``params`` (a nested dict of fp32
    tensors, e.g. ``lm.param_tree``), ``state["m"]``, ``state["v"]`` and
    ``state["step"]``; ``grads`` is keyed like ``params`` (``None`` for
    a leaf with no gradient: zeros). Returns the
    metrics {"grad_norm", "lr"} (float32 0-d tensors). One rank of
    :func:`apply_updates_ranks`."""
    return apply_updates_ranks([params], [grads], [state], cfg, {},
                               {"model": 1})


@torch.no_grad()
def apply_updates_ranks(params: list, grads: list, states: list,
                        cfg: AdamWConfig, specs: dict,
                        mesh_shape: dict, mesh=None) -> dict:
    """:func:`apply_updates` over the ranks of a mesh: ``params``,
    ``grads`` and ``states`` hold one tree per rank (row-major over the
    axes of ``mesh_shape``, axis -> size in the mesh's order); ``specs``
    maps each leaf's dotted path to its spec (``lm.leaf_specs``; a leaf
    it leaves out is replicated). The gradients of the
    ranks that hold the same block are summed (in rank order, on the
    first one's device) and written back into each of them, IN PLACE.
    The global norm sums the leaves' squares in sorted-key order, each
    distinct block once (:func:`global_norm` at one rank). ``mesh``: a
    mesh over processes (``Mesh.procs``), whose ranks ``mesh.local``
    the trees are. Returns the first rank's metrics."""
    g_l = [{k: torch.zeros_like(p, dtype=torch.float32) if g is None else g
            for (k, g), (_, p) in zip(tree_items(gt), tree_items(pt))}
           for gt, pt in zip(grads, params)]
    coords = rank_coords(mesh_shape)
    local = range(len(g_l)) if mesh is None else mesh.local
    dev0 = next(iter(g_l[0].values())).device
    parts_of: dict = {}
    for path in g_l[0]:
        spec = specs.get(path) or ()
        axes = {a for p in spec for a in ((p,) if isinstance(p, str)
                                          else (p or ()))}
        groups: dict = {}
        for r, c in enumerate(coords):
            groups.setdefault(tuple(c[a] for a in sorted(axes)),
                              []).append(r)
        copies = _copies(g_l, path, list(groups.values()), local, mesh,
                         axes)
        parts = []
        for ranks in groups.values():
            held = [r for r in ranks if r in local]
            tot = copies(ranks) if held else None
            if len(ranks) > 1:
                for r in held:
                    g_l[r - local.start][path].copy_(tot)
            # a block's square sum counts once: at its first rank's process
            parts.append(tot.square().sum() if ranks[0] in local else None)
        parts_of[path] = parts
    if mesh is not None and mesh.procs is not None:
        parts_of = _every_part(parts_of, mesh, dev0)
    sq = [parts[0] if len(parts) == 1 else torch.stack(
          [to_device(t, dev0) for t in parts]).sum()
          for parts in parts_of.values()]
    gnorm = torch.stack(sq).sum().sqrt()
    out = [_step(p, g, s, cfg, to_device(gnorm, s["step"].device))
           for p, g, s in zip(params, g_l, states)]
    return out[0]


def _copies(g_l, path, groups, local, mesh, axes):
    """``sum(ranks)``: the float32 sum of the gradients of a copy group's
    ``ranks`` in rank order (left to right), for a group of which this
    process holds a rank. Members other processes hold come from one
    ``share`` over the processes that hold the leaf's copies, made here
    for every group that spans processes."""
    def own(r):
        return g_l[r - local.start][path]
    have: dict = {}
    spans = [rs for rs in groups if any(r in local for r in rs)
             and not all(r in local for r in rs)]
    if spans:
        link = mesh.across(tuple(a for a in ("pod", "data")
                                 if a not in axes))
        order = [r for rs in spans for r in rs]
        mine = [r for r in order if r in local]
        every = link.share(torch.stack([own(r).float() for r in mine]))
        n = len(local)
        for i, q in enumerate(link.members):
            held = [r for r in order if q * n <= r < (q + 1) * n]
            have.update({r: every[i, j] for j, r in enumerate(held)})

    def total(ranks):
        def g(r):
            return have[r] if r in have else own(r)
        tot = g(ranks[0]).float()
        for r in ranks[1:]:
            tot = tot + to_device(g(r), tot.device).float()
        return tot
    return total


def _every_part(parts_of: dict, mesh, dev) -> dict:
    """Every block's square sum on every process: each process's parts
    (None where another process holds the block's first rank) summed
    over the processes, one flat all-reduce whose every entry has one
    non-zero term (exact)."""
    flat = torch.stack([torch.zeros((), device=dev) if t is None
                        else to_device(t, dev).float()
                        for parts in parts_of.values() for t in parts])
    flat = mesh.across(("pod", "data")).all_reduce(flat)
    out, i = {}, 0
    for path, parts in parts_of.items():
        out[path] = list(flat[i:i + len(parts)])
        i += len(parts)
    return out


def _step(params: dict, g_l: dict, state: dict, cfg: AdamWConfig,
          gnorm: torch.Tensor) -> dict:
    p_items = list(tree_items(params))
    m_l = dict(tree_items(state["m"]))
    v_l = dict(tree_items(state["v"]))
    state["step"] += 1
    step = state["step"]
    if cfg.grad_clip:
        clip = torch.clamp_max(cfg.grad_clip / gnorm.clamp_min(1e-9), 1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=step.device)
    lr = cfg.lr(step) if callable(cfg.lr) else torch.full(
        (), cfg.lr, dtype=torch.float32, device=step.device)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)
    for key, p in p_items:
        g = g_l[key].float() * clip
        m, v = m_l[key], v_l[key]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / ((v / b2c).sqrt() + cfg.eps)
        if cfg.weight_decay and not any(s in _path(key)
                                        for s in cfg.no_decay):
            delta = delta + cfg.weight_decay * p.float()
        p.sub_(lr * delta)
    return {"grad_norm": gnorm, "lr": lr}
