"""Logical-axis -> mesh-axis sharding rules (the port's copy of
``repro.distributed.sharding_rules``, without JAX).

Params carry *logical* axis names ("embed", "mlp", "heads", ...). A
:class:`Rules` object maps those to mesh axes, with JAX's divisibility
fallback: a logical dim that does not divide by the mesh axes it maps to
is replicated for that tensor, and the degradation is recorded.

The port's mesh has only the ``model`` axis (``distributed.context``):
``data`` and ``pod`` have size 1, so a logical axis mapped to them is
replicated. A spec is a tuple with one entry per tensor dim (``None``,
or the mesh axis name), as JAX's ``PartitionSpec`` holds.

:func:`shard_tree` cuts a tree of global tensors into per-rank trees of
shard-shaped leaves (rank r holds block r of the ``model``-sharded dim)
and :func:`unshard_tree` is its inverse; both read the logical axes of
the tree's spec (``models.lm.lm_spec``), as the JAX package's shardings
do.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.models.module import tree_items, tree_map

# Default logical->mesh mapping (JAX's table, word for word). "fsdp"
# shards params over the data axis (ZeRO-3 style); the pod axis is pure
# DP unless a rule lists it explicitly.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # params
    "vocab": ("model",),
    "in_vocab": ("data",),       # input embed storage rows (FSDP)
    "in_embed": ("model",),      # input embed cols (gather stays local)
    "embed": ("data",),          # fsdp axis for the embedding/residual dim
    "embed_no_fsdp": (),
    "mlp": ("model",),           # d_ff tensor-parallel
    "heads": ("model",),         # attention heads tensor-parallel
    "kv_heads": ("model",),
    "head_dim": (),
    "qkv": ("model",),           # fused qkv output dim
    "experts": ("model",),       # expert parallelism
    "expert_mlp": (),            # per-expert d_ff (used when experts < model)
    "layers": (),                # scan-stacked layer dim
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv_width": (),
    # activations
    "batch": ("pod", "data"),
    "seq": ("model",),           # sequence parallelism between blocks
    "kv_seq": ("model",),        # decode KV cache sequence sharding
    "act_embed": (),
    "act_mlp": ("model",),
    "act_heads": ("model",),
}


@dataclasses.dataclass
class Rules:
    """``shape``: mesh axis -> size (axes it does not name have size 1)."""
    shape: Mapping[str, int]
    table: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    degradations: list[str] = dataclasses.field(default_factory=list)

    def _mesh_size(self, mesh_axes: tuple[str, ...]) -> int:
        n = 1
        for a in mesh_axes:
            n *= self.shape.get(a, 1)
        return n

    def spec_for(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int] | None = None,
                 name: str = "") -> tuple:
        """The spec of one tensor, applying the divisibility fallback."""
        parts = []
        for i, ax in enumerate(logical_axes):
            if ax is None or ax not in self.table:
                parts.append(None)
                continue
            mesh_axes = tuple(a for a in self.table[ax]
                              if self.shape.get(a, 1) > 1)
            if not mesh_axes:
                parts.append(None)
                continue
            if shape is not None:
                n = self._mesh_size(mesh_axes)
                if shape[i] % n != 0:
                    self.degradations.append(
                        f"{name or 'tensor'} axis {i} ({ax}={shape[i]}) not "
                        f"divisible by mesh {mesh_axes} ({n}) -> replicated")
                    parts.append(None)
                    continue
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        # a spec must not repeat a mesh axis; later occurrences degrade
        seen: set[str] = set()
        clean = []
        for p in parts:
            axes = (p,) if isinstance(p, str) else (p or ())
            if any(a in seen for a in axes):
                clean.append(None)
                continue
            seen.update(axes)
            clean.append(p)
        return tuple(clean)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def shard_dim(self, logical_axes, shape, name: str = "") -> int | None:
        """The dim of a tensor that the ``model`` axis shards, or None
        (replicated)."""
        spec = self.spec_for(logical_axes, shape, name)
        dims = [i for i, p in enumerate(spec) if p is not None]
        for i in dims:
            if spec[i] != "model":
                raise NotImplementedError(
                    f"{name}: spec {spec} shards over {spec[i]!r}; the "
                    f"port's mesh has only the 'model' axis")
        return dims[0] if dims else None


def rules_for(cfg, mesh) -> Rules:
    """Rules for ``mesh`` (a ``distributed.context.Mesh``, or None for
    one rank) with ``cfg.sharding_overrides`` applied."""
    table = dict(DEFAULT_RULES)
    for k, v in (getattr(cfg, "sharding_overrides", ()) or ()):
        table[k] = tuple(v)
    W = 1 if mesh is None else mesh.size
    return Rules({"data": 1, "model": W}, table=table)


def shard_dims(spec: dict, rules: Rules, prefix: str = "") -> dict:
    """``{dotted path: sharded dim or None}`` for every leaf of ``spec``,
    a tree whose leaves carry ``.axes`` and ``.shape`` (the ``Param``
    declarations of ``models.lm.lm_spec``)."""
    out = {}
    for k in sorted(spec):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(spec[k], dict):
            out.update(shard_dims(spec[k], rules, path))
        else:
            out[path] = rules.shard_dim(spec[k].axes, spec[k].shape, path)
    return out


def shard_shape(shape, dim: int | None, W: int) -> tuple:
    """The per-rank shape of a leaf of global ``shape`` whose ``dim`` is
    split in W blocks (``None``: replicated, the whole shape); JAX's
    ``NamedSharding.shard_shape``."""
    shape = tuple(shape)
    if dim is None:
        return shape
    return shape[:dim] + (shape[dim] // W,) + shape[dim + 1:]


def shard_tree(tree: dict, spec: dict, rules: Rules,
               devices=None, share_replicated: bool = False) -> list[dict]:
    """Per-rank trees of ``tree``'s global leaves: a sharded leaf's block
    r (a contiguous copy) on rank r, a replicated leaf's own copy on
    every rank (ranks that share a device still hold separate tensors,
    as training writes each), or with ``share_replicated`` one copy per
    distinct device, which every rank on it holds (serving: nothing
    writes them). ``devices``: one per rank (default: the leaves'
    own)."""
    W = rules.model_size
    dims = shard_dims(spec, rules)
    shared: dict = {}

    def one(r):
        def cut(path, x):
            d = dims[path]
            x = x.detach()
            dev = x.device if devices is None else devices[r]
            if d is None and share_replicated:
                key = (path, str(dev))
                if key not in shared:
                    shared[key] = x.to(dev, copy=True,
                                       memory_format=torch.contiguous_format)
                return shared[key]
            if d is not None:
                n = x.shape[d] // W
                x = x.narrow(d, r * n, n)
            return x.to(dev, copy=True,
                        memory_format=torch.contiguous_format)
        return tree_map(cut, tree)
    return [one(r) for r in range(W)]


def unshard_tree(trees: list[dict], spec: dict, rules: Rules) -> dict:
    """The global tree of per-rank ``trees`` (inverse of
    :func:`shard_tree`) on rank 0's device: sharded leaves concatenated
    in rank order, replicated leaves rank 0's copy."""
    dims = shard_dims(spec, rules)
    flat = [dict(tree_items(t)) for t in trees]

    def join(path, x):
        d = dims[path]
        if d is None:
            return x.detach().clone()
        return torch.cat([f[path].detach().to(x.device) for f in flat],
                         dim=d)
    return tree_map(join, trees[0])
