"""Logical-axis -> mesh-axis sharding rules (the port's copy of
``repro.distributed.sharding_rules``, without JAX).

Params carry *logical* axis names ("embed", "mlp", "heads", ...). A
:class:`Rules` object maps those to mesh axes, with JAX's divisibility
fallback: a logical dim that does not divide by the mesh axes it maps to
is replicated for that tensor, and the degradation is recorded.

The mesh's axes are ``model``, ``data`` and ``pod``
(``distributed.context``); an axis of size 1 shards nothing. A spec is a
tuple with one entry per tensor dim (``None``, a mesh axis name, or a
tuple of them), as JAX's ``PartitionSpec`` holds. By the default table
a weight is cut over ``model`` on its heads / MLP / expert / vocab dim
and over ``data`` on its ``embed`` (or ``in_vocab``) dim: FSDP, ZeRO-3
style.

:func:`make_shards` builds per-rank trees of shard-shaped leaves from
draws, each rank's block cut out of one layer slice or one unstacked
leaf at a time (born sharded, as JAX's ``jit(init, out_shardings=)``:
no device ever holds a whole model), and :func:`shard_tree` the same
trees from a tree of global tensors (the rank at coordinates (d, m)
holds block d of the ``data``-sharded dim and block m of the
``model``-sharded one, JAX's ``NamedSharding.shard_shape``; the ranks
numbered row-major over the mesh's axes); :func:`unshard_tree` is their
inverse; all read the
logical axes of the tree's spec (``models.lm.lm_spec``), as the JAX
package's shardings do.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

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


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def rules_for(cfg, mesh) -> Rules:
    """Rules for ``mesh`` (a ``distributed.context.Mesh``, or anything
    with a ``shape`` of axis sizes; None for one rank) with
    ``cfg.sharding_overrides`` applied."""
    table = dict(DEFAULT_RULES)
    for k, v in (getattr(cfg, "sharding_overrides", ()) or ()):
        table[k] = tuple(v)
    shape = {"data": 1, "model": 1} if mesh is None else dict(mesh.shape)
    return Rules(shape, table=table)


def leaf_specs(spec: dict, rules: Rules, prefix: str = "") -> dict:
    """``{dotted path: spec}`` for every leaf of ``spec``, a tree whose
    leaves carry ``.axes`` and ``.shape`` (the ``Param`` declarations of
    ``models.lm.lm_spec``)."""
    out = {}
    for k in sorted(spec):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(spec[k], dict):
            out.update(leaf_specs(spec[k], rules, path))
        else:
            out[path] = rules.spec_for(spec[k].axes, spec[k].shape, path)
    return out


def dim_of(spec: tuple, axis: str) -> int | None:
    """The dim of a spec that ``axis`` cuts, or None."""
    for i, p in enumerate(spec):
        if axis in spec_axes(p):
            return i
    return None


def shard_dims(spec: dict, rules: Rules, axis: str = "model") -> dict:
    """``{dotted path: the dim ``axis`` shards, or None}`` for every leaf
    of ``spec`` (:func:`leaf_specs`)."""
    return {path: dim_of(s, axis)
            for path, s in leaf_specs(spec, rules).items()}


def n_blocks(entry, mesh_shape) -> int:
    """The blocks one spec entry cuts a dim into."""
    n = 1
    for a in spec_axes(entry):
        n *= mesh_shape.get(a, 1)
    return n


def spec_shape(shape, spec: tuple, mesh_shape) -> tuple:
    """The per-rank shape of a leaf of global ``shape`` cut by ``spec``
    over a mesh of axis sizes ``mesh_shape``: JAX's
    ``NamedSharding(mesh, spec).shard_shape``."""
    return tuple(n // n_blocks(p, mesh_shape) for n, p in zip(shape, spec))


def batch_spec(shape, mesh_shape) -> tuple:
    """JAX's ``batch_sharding`` spec of a batch leaf of global ``shape``:
    dim 0 over the ``("pod", "data")`` axes (those of more than one
    rank) where it divides by their product, else replicated (every data
    group holds the whole batch); the other dims replicated."""
    axes = tuple(a for a in ("pod", "data") if mesh_shape.get(a, 1) > 1)
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    ok = axes and len(shape) and shape[0] % n == 0
    head = (axes if len(axes) > 1 else axes[0]) if ok else None
    return (head,) + (None,) * (len(shape) - 1)


def decode_state_spec(path: str, shape, rules: Rules) -> tuple:
    """JAX's ``decode_state_shardings`` spec of one leaf of a contiguous
    decode state (``path`` dotted, ``shape`` global): an attention KV
    cache (a ``"k"``/``"v"`` leaf of 4 or more dims, (..., B, S, KVH,
    hd)) has its batch dim on the ``("pod", "data")`` axes
    (:func:`batch_spec`) and its sequence dim on ``model``, each where
    it divides; another leaf whose dim 0 is more than 1 (the recurrent
    state stacked by layer, (layers, B, ...)) has dim 1 on the batch
    axes where it divides; the rest (``cur_len``) is replicated."""
    shape = tuple(shape)
    nd = len(shape)
    spec = [None] * nd
    if path.rsplit(".", 1)[-1] in ("k", "v") and nd >= 4:
        lead = nd - 4
        spec[lead] = batch_spec(shape[lead:], rules.shape)[0]
        if rules.model_size > 1 and shape[lead + 1] % rules.model_size == 0:
            spec[lead + 1] = "model"
    elif nd >= 2 and shape[0] > 1:
        spec[1] = batch_spec(shape[1:], rules.shape)[0]
    return tuple(spec)


def pool_blocks(n_blocks: int, ranks: int,
                rules: Rules | None = None) -> tuple:
    """(blocks a rank, blocks of padding) of a paged KV pool of
    ``n_blocks`` over ``ranks`` ranks. Over a mesh with data groups the
    port splits the pool's blocks over every rank (global block t on
    rank t // n_loc), which holds the bytes a rank of JAX's spec (blocks
    on ``("pod", "data")``, ``block_size`` on ``model``); a count that
    does not divide is padded with blocks no table names (the pool
    keeps its ``n_blocks``, JAX's rounding to the ``model`` axis), at
    most JAX's fallback bytes (every block on each group), and the
    padding is recorded in ``rules.degradations``."""
    n_loc = -(-n_blocks // ranks)
    pad = n_loc * ranks - n_blocks
    if pad and rules is not None:
        rules.degradations.append(
            f"paged pool n_blocks={n_blocks} not divisible by the mesh's "
            f"{ranks} ranks -> {n_loc} blocks a rank, {pad} of padding")
    return n_loc, pad


def rank_coords(mesh_shape) -> list:
    """Every rank's ``{axis: coordinate}``, ranks row-major over the axes
    in ``mesh_shape``'s order."""
    out = [{}]
    for a, n in mesh_shape.items():
        out = [{**c, a: i} for c in out for i in range(n)]
    return out


def _block_index(entry, coords, mesh_shape) -> int:
    b = 0
    for a in spec_axes(entry):
        b = b * mesh_shape.get(a, 1) + coords.get(a, 0)
    return b


def cut(x, spec: tuple, coords: dict, mesh_shape):
    """The block of ``x`` that the rank at ``coords`` holds under
    ``spec`` (a view)."""
    for i, p in enumerate(spec):
        n = n_blocks(p, mesh_shape)
        if n > 1:
            m = x.shape[i] // n
            x = x.narrow(i, _block_index(p, coords, mesh_shape) * m, m)
    return x


def join(blocks: list, spec: tuple, mesh_shape):
    """The global tensor of the per-rank ``blocks`` (ranks row-major over
    ``mesh_shape``) cut by ``spec``, on rank 0's device: the inverse of
    :func:`cut`. Ranks that hold the same block give it once (the first
    one's copy)."""
    if all(n_blocks(p, mesh_shape) == 1 for p in spec):
        return blocks[0].detach().clone()
    b0 = blocks[0]
    shape = [n * n_blocks(p, mesh_shape) for n, p in zip(b0.shape, spec)]
    out = torch.empty(shape, dtype=b0.dtype, device=b0.device)
    seen = set()
    for c, b in zip(rank_coords(mesh_shape), blocks):
        key = tuple(_block_index(p, c, mesh_shape) for p in spec)
        if key not in seen:
            seen.add(key)
            cut(out, spec, c, mesh_shape).copy_(b.detach())
    return out


def make_shards(spec: dict, rules: Rules, devices, draw, dtype_of,
                share_replicated: bool = False) -> list[dict]:
    """Per-rank trees of ``spec``'s leaves, one per rank of the mesh
    ``rules.shape`` describes (row-major), rank r's on ``devices[r]``,
    built from draws, never from a global leaf on one device: each rank
    holds its block of every leaf (:func:`cut` by the leaf's spec) in
    ``dtype_of(path)``, a replicated leaf's own copy on every rank (ranks
    that share a device still hold separate tensors, as training writes
    each), or with ``share_replicated`` one copy per distinct device,
    which every rank on it holds (serving: nothing writes them). A rank
    whose device is None (another process holds it,
    ``distributed.processes``) is not built: the trees are those of the
    other ranks, in rank order.

    ``draw(path, device)`` gives the leaf's values on ``device``, asked
    once per distinct device: an iterable of ``(l, layer slice l)`` of a
    layer-stacked leaf, in any order, or ``(None, the whole leaf)``
    (``models.module.draws``; the values may lie on another device); a
    number (every entry that value: a ``zeros`` / ``ones`` leaf, made at
    block shape with no draw); or None (the blocks are left unwritten,
    for a restore to fill). Every rank's block on the device is cut out
    of each piece and cast as it is written, so a device holds its
    ranks' blocks plus one piece."""
    specs = leaf_specs(spec, rules)
    coords = rank_coords(rules.shape)
    devices = list(devices)
    trees: list[dict] = [{} for _ in coords]
    for path, p in tree_items(spec):
        s, dt = specs[path], dtype_of(path)
        shape = spec_shape(p.shape, s, rules.shape)
        for dev in dict.fromkeys(d for d in devices if d is not None):
            ranks = [r for r, d in enumerate(devices) if d == dev]
            shared = share_replicated and not any(s)
            with torch.no_grad():
                made = [torch.empty(shape, dtype=dt, device=dev)
                        for _ in ranks[:1 if shared else None]]
                _fill(made, [coords[r] for r in ranks], s, rules.shape,
                      draw(path, dev))
            for i, r in enumerate(ranks):
                trees[r][path] = made[0 if shared else i]
    return [tree_map(lambda path, _: t[path], spec)
            for t, d in zip(trees, devices) if d is not None]


def _fill(blocks, coords, spec, mesh_shape, values):
    """Write each rank's block (``blocks[i]`` of the rank at
    ``coords[i]``) from ``values`` (:func:`make_shards`'s ``draw``)."""
    if values is None:
        return
    if not isinstance(values, Iterable):
        for b in blocks:
            b.fill_(values)
        return
    for layer, x in values:
        for b, c in zip(blocks, coords):
            if layer is None:
                b.copy_(cut(x, spec, c, mesh_shape))
                continue
            # the rank's block of a stacked leaf holds layers
            # [k m, (k + 1) m) where the rules cut the layer dim
            i = layer - _block_index(spec[0], c, mesh_shape) * b.shape[0]
            if 0 <= i < b.shape[0]:
                b[i].copy_(cut(x, spec[1:], c, mesh_shape))


def shard_tree(tree: dict, spec: dict, rules: Rules,
               devices=None, share_replicated: bool = False) -> list[dict]:
    """:func:`make_shards` of ``tree``'s global leaves, each in its own
    dtype: a caller that already holds the whole tree. ``devices``: one
    per rank (default: every rank on the leaves' device)."""
    leaves = dict(tree_items(tree))
    if devices is None:
        devices = [next(iter(leaves.values())).device] * len(
            rank_coords(rules.shape))
    return make_shards(spec, rules, devices,
                       lambda path, _: [(None, leaves[path].detach())],
                       lambda path: leaves[path].dtype, share_replicated)


def unshard_tree(trees: list[dict], spec: dict, rules: Rules) -> dict:
    """The global tree of per-rank ``trees`` (inverse of
    :func:`shard_tree`) on rank 0's device (:func:`join`)."""
    specs = leaf_specs(spec, rules)
    flat = [dict(tree_items(t)) for t in trees]
    return tree_map(lambda path, _: join([f[path] for f in flat],
                                         specs[path], rules.shape), trees[0])
