"""Top-level LM: the training forward and loss, and the decode entry
points (port of ``repro.models.lm``).

:class:`LM` is an ``nn.Module`` holding the parameter tree keyed like the
JAX tree (``embed.table``, ``backbone.layers.attn.wq``, ``ln_f.scale``,
``head.table``); it indexes like the JAX dict (``params["backbone"]``),
so the functional code reads either. It comes in two forms:

* serving (the default): frozen, weight matrices and the input
  embedding stored in ``cfg.dtype`` (what JAX's per-call
  ``.astype(x.dtype)`` computes with), norm scales and the output head
  in fp32 (JAX's unembed promotes a bf16 ``x`` against the fp32 head
  table, so the logits are an fp32 product), and the leaves JAX reads
  as fp32 masters in fp32 (:data:`FP32_LEAVES`: the MoE router, the
  recurrent blocks' decay and norm parameters);
* trainable (``trainable=True``): every leaf an fp32 master
  (``cfg.param_dtype``) with ``requires_grad``, as JAX trains; the
  forward casts each weight to ``cfg.dtype`` per call, so gradients
  land in fp32 on the masters.

Over the W ranks of the ambient mesh (``distributed.context``) the
training forward and loss take a list of W :class:`LM` holding each
rank's shards (born sharded by :func:`init_params` with a mesh, or
cut from a whole model by :func:`shard_params`; Megatron-style by the
sharding rules: attention heads, MLP columns and the vocab split over
the ranks, the input table's columns too, or its rows where a config's
overrides say so (paligemma's tied table); norm scales and ``frontend_proj``
copied to every rank) and
run the paper's sequence-parallel AG+GEMM and GEMM+RS at the projection
sites (``core.patterns``); the loss is vocab-parallel
(:func:`cross_entropy_ranks`). Over a (data, model) mesh (``pod`` x
``data`` data groups of W ranks) the list holds one :class:`LM` a rank,
every weight also cut over ``data`` on its ``embed`` / ``in_vocab`` dim
(FSDP, JAX's rules); each data group runs the W-rank path on its rows
of the batch, gathering the FSDP blocks per layer inside the remat
scope (``distributed.fsdp``), and the loss is the global mean over every
group's tokens, the MoE aux loss the global batch's
(:func:`loss_fn`).

Decode state is a dict ``{"caches", "cur_len"}`` (plus
``"block_tables"`` when paged) as in JAX, ``caches`` the block's tree
(``transformer``: KV, and per-slot recurrent state for the hybrid and
rwkv), but the entry points update it IN PLACE (every cache leaf,
``cur_len``) and return the same dict, where JAX returns new arrays.
Over the W ranks of the ambient mesh (``distributed.context``) the KV
leaves are per-rank shard lists and the other leaves (the recurrent
state, ``cur_len``, the tables) one copy per distinct device.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.core import collective_matmul as cm
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models import moe, transformer
from repro_torch.models.layers import (apply_embed, apply_norm, apply_unembed,
                                       dense, embed_spec, norm_spec)
from repro_torch.models.module import Param, leaf_values, tree_items, tree_map


def lm_spec(cfg):
    transformer.require_ported(cfg)
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "backbone": transformer.stack_spec(cfg),
        "ln_f": norm_spec(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        spec["head"] = {"table": Param((cfg.vocab_size, cfg.d_model),
                                       init="scaled",
                                       axes=("vocab", "embed"))}
    if cfg.frontend_dim:
        spec["frontend_proj"] = {
            "kernel": Param((cfg.frontend_dim, cfg.d_model), init="scaled",
                            axes=(None, "embed"))}
    if cfg.block == "rwkv":
        spec["ln_in"] = norm_spec(cfg.d_model, "layernorm")
    return spec


# leaves JAX reads as fp32 masters: norm scales and biases, the MoE
# router (a bf16 router would flip experts at near-ties), Mamba2's A_log,
# dt_bias, D and norm_scale, RWKV6's decay (w0 and its LoRA), bonus u
# and GroupNorm scale
FP32_LEAVES = ("scale", "bias", "router", "A_log", "dt_bias", "D",
               "norm_scale", "w0", "w_lora_a", "w_lora_b", "u", "gn_scale")


def storage_dtype(path: str, cfg) -> torch.dtype:
    """How the port stores the leaf at dotted ``path``: fp32 for
    ``FP32_LEAVES`` and the output head, ``cfg.dtype`` (what JAX's
    per-call ``.astype(x.dtype)`` computes with) otherwise."""
    leaf = path.rsplit(".", 1)[-1]
    if path == "head.table" or leaf in FP32_LEAVES:
        return torch.float32
    if path == "embed.table" and cfg.tie_embeddings:
        return torch.float32          # it is also the fp32 unembed table
    return cfg.dtype


def _dtype(path: str, cfg, trainable: bool) -> torch.dtype:
    return cfg.param_dtype if trainable else storage_dtype(path, cfg)


def _module(tree: dict, trainable: bool) -> nn.Module:
    if all(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _module(v, trainable)
                              for k, v in tree.items()})
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
                                 for k, v in tree.items()})
    return _Mixed(tree, trainable)


class _Mixed(nn.Module):
    """A level that holds sub-trees beside tensors (an RWKV6 layer: the
    ``ln_t``/``ln_c`` norms beside its weights); it indexes and
    iterates like a dict, as the ``ModuleDict``/``ParameterDict`` levels
    do."""

    def __init__(self, tree: dict, trainable: bool):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _module(v, trainable))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=trainable))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def items(self):
        return [*self._parameters.items(), *self._modules.items()]


class LM(nn.Module):
    """Parameter tree of a decoder LM, keyed like the JAX tree.
    ``split``: on one rank's shards (:func:`shard_params`) the
    :func:`split_axes` tree they were cut by; None on whole weights."""

    split: dict | None = None

    def __init__(self, cfg, tree: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for k, v in tree.items():
            self.add_module(k, _module(v, trainable))

    def __getitem__(self, key: str):
        return self._modules[key]

    @property
    def device(self) -> torch.device:
        return self["embed"]["table"].device


def from_tree(cfg, tree: dict, trainable: bool = False) -> LM:
    """Build an :class:`LM` from a nested dict of tensors, checking it
    against :func:`lm_spec` key for key and shape for shape, and casting
    every leaf to its storage dtype (``trainable``: an fp32 master)."""
    spec = dict(tree_items(lm_spec(cfg)))
    got = dict(tree_items(tree))
    if set(spec) != set(got):
        raise ValueError(f"parameter keys differ from lm_spec: missing "
                         f"{sorted(set(spec) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(spec))}")
    for path, p in spec.items():
        if tuple(got[path].shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {tuple(got[path].shape)} != "
                             f"spec {p.shape}")

    def build(t, prefix=""):
        out = {}
        for k, v in t.items():
            path = f"{prefix}.{k}" if prefix else k
            out[k] = build(v, path) if isinstance(v, dict) \
                else v.to(_dtype(path, cfg, trainable))
        return out
    return LM(cfg, build(tree), trainable)


def init_params(cfg, *, seed: int = 0, device="cuda",
                trainable: bool = False, mesh=None):
    """Seeded random init from :func:`lm_spec` (``models.module.draws``:
    a generator a leaf, seeded from ``seed`` and the leaf's path, a
    stacked leaf drawn a layer slice at a time; no weights are read from
    anywhere) on ``device``; ``trainable`` gives fp32 masters that require
    grad. With a ``mesh`` of W > 1 ranks the parameters are born sharded,
    as JAX's trainer builds them (``jit(init_params, out_shardings=)``):
    each rank's blocks (:func:`shard_params`'s, dtypes, devices and shared
    replicated leaves alike, bit for bit) are cut out of draws made on
    their own device (``sharding_rules.make_shards``), so no device holds
    more than its ranks' blocks plus one slice or unstacked leaf drawn in
    fp32. One seed gives the same numbers on every mesh."""
    leaves = dict(tree_items(lm_spec(cfg)))
    return _build(cfg, device, trainable, mesh, lambda path, dev: (
        leaf_values(leaves[path], seed=seed, path=path, device=dev)))


def empty_params(cfg, *, device="cuda", trainable: bool = False,
                 mesh=None):
    """:func:`init_params`'s tensors, left unwritten: what a restore fills
    (``launch.serve.load_params``)."""
    return _build(cfg, device, trainable, mesh, lambda path, dev: None)


def _build(cfg, device, trainable: bool, mesh, draw):
    """One :class:`LM` on ``device`` (or the one rank of ``mesh``), or
    per-rank LMs over a ``mesh`` of W > 1 ranks, of the leaves ``draw``
    gives (``sharding_rules.make_shards``)."""
    one = mesh is None or mesh.size == 1
    trees = sr.make_shards(
        lm_spec(cfg), sr.rules_for(cfg, None if one else mesh),
        [resolve_device(device if mesh is None else mesh.devices[0])]
        if one else mesh.devices, draw,
        lambda path: _dtype(path, cfg, trainable),
        share_replicated=not trainable)
    if one:
        return LM(cfg, trees[0], trainable)
    return _rank_lms(cfg, mesh, trees, trainable)


def _rank_lms(cfg, mesh, trees: list, trainable: bool) -> list:
    split = split_axes(cfg, mesh)
    out = [LM(cfg, t, trainable) for t in trees]
    for p in out:
        p.split = split
    return out


def shard_dims(cfg, mesh) -> dict:
    """``{dotted path: the dim the model axis shards, or None}`` of every
    parameter leaf for ``mesh`` (``sharding_rules.rules_for``)."""
    return sr.shard_dims(lm_spec(cfg), sr.rules_for(cfg, mesh))


def data_dims(cfg, mesh) -> dict:
    """``{dotted path: the dim the data axis shards (FSDP), or None}`` of
    every parameter leaf for ``mesh``."""
    return sr.shard_dims(lm_spec(cfg), sr.rules_for(cfg, mesh), "data")


def leaf_specs(cfg, mesh) -> dict:
    """``{dotted path: spec}`` of every parameter leaf for ``mesh``: JAX's
    ``param_shardings`` specs, one entry a dim (None, or the mesh axes
    that split it)."""
    return sr.leaf_specs(lm_spec(cfg), sr.rules_for(cfg, mesh))


def split_axes(cfg, mesh) -> dict:
    """The parameter tree with, at every leaf, the logical axis that the
    ``model`` axis of ``mesh`` splits (``"heads"``, ``"mlp"``,
    ``"experts"``, ``"vocab"``, ...), or None where the sharding rules
    keep the leaf whole (every leaf when ``mesh`` is None): how
    :func:`shard_params` cuts, and what the decode sites read to tell a
    rank's block from a whole weight (:func:`decode_step`)."""
    spec = lm_spec(cfg)
    dims = shard_dims(cfg, mesh)
    return tree_map(lambda path, p: None if dims[path] is None
                    else p.axes[dims[path]], spec)


@functools.lru_cache(maxsize=None)
def _whole(cfg) -> dict:
    return split_axes(cfg, None)


def shard_params(params: LM, mesh) -> list:
    """The per-rank :class:`LM` of ``params`` over ``mesh`` (JAX's
    ``param_shardings``): rank r on ``mesh.devices[r]`` holds block r of
    every leaf the rules shard over ``model`` (attention heads, MLP and
    ``ssm_inner`` columns, the experts or their ``expert_mlp`` columns,
    the vocab; the divisibility fallback replicates, as recorded by
    ``sharding_rules``), each in the dtype ``params`` stores it in. A
    trainable ``params`` gives every rank its own copy of every
    replicated leaf (also where ranks share a card, so the same code
    runs on virtual and real ranks, and each copy takes its update); a
    serving one (``storage_dtype``: fp32 head and :data:`FP32_LEAVES`,
    ``cfg.dtype`` otherwise) one copy per distinct device, shared by its
    ranks, which :func:`decode_step` reads once per device. Each rank's
    ``split`` is :func:`split_axes`. For callers that already hold a
    whole model (a test's, a converted tree); the entry points build
    their shards born sharded (:func:`init_params` with a mesh)."""
    cfg = params.cfg
    trainable = any(p.requires_grad for p in params.parameters())
    trees = sr.shard_tree(param_tree(params), lm_spec(cfg),
                          sr.rules_for(cfg, mesh), devices=mesh.devices,
                          share_replicated=not trainable)
    return _rank_lms(cfg, mesh, trees, trainable)


def device_of(params) -> torch.device:
    """The device of an :class:`LM`, or of the first of a per-rank or
    per-device list of them."""
    return as_ranks(params)[0].device


def gather_params(shards: list, mesh) -> LM:
    """The global :class:`LM` of per-rank ``shards`` (inverse of
    :func:`shard_params`) on rank 0's device."""
    cfg = shards[0].cfg
    trainable = any(p.requires_grad for p in shards[0].parameters())
    tree = sr.unshard_tree([param_tree(p) for p in shards], lm_spec(cfg),
                           sr.rules_for(cfg, mesh))
    return LM(cfg, tree, trainable)


def gather_grads(shards: list, mesh) -> dict:
    """``{dotted path: the global gradient}`` of per-rank ``shards``
    after a train step over ``mesh`` (``launch.steps.make_train_step``),
    on rank 0's device: the blocks joined, as :func:`gather_params`
    joins the parameters (the optimizer wrote the sum over each block's
    copies into every copy: what JAX's ``value_and_grad`` returns)."""
    specs = leaf_specs(shards[0].cfg, mesh)
    named = [dict(p.named_parameters()) for p in shards]
    return {path: sr.join([nm[path].grad for nm in named], spec,
                          mesh.shape) for path, spec in specs.items()}


def param_tree(params: LM) -> dict:
    """The parameters of ``params`` as a nested dict keyed like the JAX
    tree, holding the module's own tensors (what the optimizer and the
    checkpointer take)."""
    tree: dict = {}
    for name, t in params.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def _head(params, cfg):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["head"]["table"])


def logits_fn(params, x, cfg, *, seq_sharded: bool = True):
    """Unembed: fp32 product against the head (or tied embedding) table,
    logits cast to bf16 as in JAX. Over W ranks (``params`` and ``x``
    per-rank lists) the sequence rows are gathered once (JAX's note: the
    vocab stays sharded) and each rank multiplies its vocab shard:
    per-rank logits (B, S, V/W), or (B, S, V) where the rules replicate
    the head."""
    if not isinstance(x, list):
        return apply_unembed({"table": _head(params, cfg)}, x,
                             dtype=torch.bfloat16)
    if seq_sharded and len(x) > 1:
        x = cm.all_gather(x, gather_axis=1)
    return [apply_unembed({"table": _head(p, cfg)}, xr,
                          dtype=torch.bfloat16) for p, xr in zip(params, x)]


# ---------------------------------------------------------- train / prefill
def as_ranks(params) -> list:
    """The per-rank list of ``params``: one :class:`LM` is W = 1."""
    return params if isinstance(params, list) else [params]


def embed_inputs(params, batch, cfg):
    """batch: dict with 'tokens' (B, S) and/or 'patches'/'frames' (B, P,
    frontend_dim). Returns (x in ``cfg.dtype``, positions (1, L),
    label_offset): x (B, L, d) for an :class:`LM`, per-rank sequence
    shards for a per-rank list (:func:`_embed_ranks`).

    As in JAX: the audio family projects its frames (``frontend_proj``,
    no token embedding); the vlm projects its patches when the batch has
    them and puts them in front of the tokens' rows, whose labels then
    start ``label_offset`` = P rows in (0 without patches). The
    projections run on the GEMM kernel in ``cfg.dtype`` (fp32
    accumulate); the token gather runs in the table's dtype, and the
    concatenation casts after it."""
    ranks = as_ranks(params)
    dev = ranks[0].device
    front = None
    if cfg.family == "audio":
        front = batch["frames"]
    elif cfg.family == "vlm" and "patches" in batch:
        front = batch["patches"]
    tokens = None if cfg.family == "audio" else batch["tokens"]
    x = _embed_ranks(ranks, tokens, cfg, front)
    L = (0 if front is None else front.shape[1]) + \
        (0 if tokens is None else tokens.shape[1])
    prefix = L - tokens.shape[1] if tokens is not None else 0
    positions = torch.arange(L, device=dev)[None, :]
    return (x if isinstance(params, list) else x[0]), positions, prefix


def _frontend(p, front, cfg):
    """The patches' or frames' projection on one rank's ``frontend_proj``
    (replicated by the rules): (B, P, fd) @ (fd, d) in ``cfg.dtype``."""
    return dense(front.to(p.device, cfg.dtype),
                 p["frontend_proj"]["kernel"].to(cfg.dtype))


def _gather(p, tokens, cfg, r: int):
    """One rank's fp32 gather of its part of the input table: every
    token's columns when the rules shard the table's columns (or every
    row and column when they replicate it); when they shard its rows
    (paligemma's ``in_vocab`` -> model), the tokens in the rank's row
    range and zeros for the others, XLA's masked gather."""
    table = p["embed"]["table"]
    ids = tokens.to(p.device).long()
    n = table.shape[0]
    if n == cfg.vocab_size:
        return apply_embed(p["embed"], ids, torch.float32)
    idx = ids - r * n
    own = (idx >= 0) & (idx < n)
    g = table[idx.clamp(0, n - 1)].to(torch.float32)
    return torch.where(own[..., None], g, 0.0)


def _embed_ranks(params, tokens, cfg, front=None):
    """The embedding over W ranks, as JAX's sharding computes it. The
    input table comes in one of three layouts: replicated, its columns
    sharded (``("in_vocab", "in_embed")``: columns over the model axis;
    each rank gathers its columns for every token, and the ranks'
    columns are all-gathered), or its rows sharded
    (paligemma's overrides: each rank gathers the tokens of its row
    range, zeros elsewhere, and the W partials are summed across the
    ranks in rank order in fp32, JAX's masked gather and all-reduce).
    The frontend projection (``front``: patches or frames, on every rank)
    goes in front of the tokens' rows before the sequence split, so each
    rank's rows are rows of the whole sequence (all rows when it does
    not divide by W). fp32 until the cast to ``cfg.dtype`` (rwkv's
    ``ln_in`` in between, on each rank's rows), as in JAX."""
    W = len(params)
    fr = [None if front is None else _frontend(p, front, cfg).float()
          for p in params]
    g = [None if tokens is None else _gather(p, tokens, cfg, r)
         for r, p in enumerate(params)]
    if tokens is not None and W > 1:
        if params[0]["embed"]["table"].shape[0] != cfg.vocab_size:
            g = cm.all_reduce(g)                # row shards: the psum
        elif g[0].shape[-1] != cfg.d_model:     # column shards
            g = cm.all_gather(g, gather_axis=-1)
    x = [t if f is None else f if t is None else torch.cat([f, t], dim=1)
         for f, t in zip(fr, g)]
    S = x[0].shape[1]
    if S % W == 0:
        x = [t.narrow(1, r * (S // W), S // W) for r, t in enumerate(x)]
    if cfg.block == "rwkv":
        x = [apply_norm(p["ln_in"], t, "layernorm")
             for p, t in zip(params, x)]
    return [t.to(cfg.dtype) for t in x]


def _forward(ranks, batch, cfg):
    """Per-rank logits of the per-rank ``ranks`` (LMs, or a data group's
    FSDP views) and the MoE layers' Switch statistics
    (``transformer.forward``; :func:`_aux` makes the aux loss)."""
    W = dctx.current().model_axis_size
    if len(ranks) != W:
        raise ValueError(f"{len(ranks)} per-rank parameter trees for a "
                         f"mesh of {W} ranks: run under dctx.use("
                         f"DistContext(mesh, ...)) with lm.shard_params("
                         f"params, mesh)")
    x, positions, _ = embed_inputs(ranks, batch, cfg)
    x, stats = transformer.forward([p["backbone"] for p in ranks], x, cfg,
                                   positions=positions)
    x = [apply_norm(p["ln_f"], xr, cfg.norm) for p, xr in zip(ranks, x)]
    return logits_fn(ranks, x, cfg, seq_sharded=positions.shape[-1]
                     % len(ranks) == 0), stats


def _data_mesh():
    """The ambient mesh when it has several data groups, else None."""
    mesh = dctx.current().mesh
    return mesh if mesh is not None and mesh.dp > 1 else None


def _groups(params, batch, cfg):
    """Run every data group of the ambient (pod, data, model) mesh on its
    rows, ``batch[g]`` (``data.pipeline.shard_batch``: one batch a
    group): yields (the group's per-rank logits, its MoE statistics, its
    rows), each group under its model-only sub-mesh (``Mesh.group``)
    with its FSDP views (``distributed.fsdp``): the ``data``-sharded
    top-level leaves (embedding, head, ``ln_f``, frontend) gathered once
    here, the backbone's per layer inside the remat scope."""
    ctx = dctx.current()
    mesh = ctx.mesh
    ranks = as_ranks(params)
    if len(ranks) != mesh.size:
        raise ValueError(f"{len(ranks)} per-rank parameter trees for a mesh "
                         f"of {mesh.size} ranks: lm.shard_params(params, "
                         f"mesh)")
    if not isinstance(batch, list) or len(batch) != mesh.dp:
        raise TypeError(f"over {mesh.dp} data groups the batch is one a "
                        f"group: data.pipeline.shard_batch(batch, device, "
                        f"mesh)")
    ddims = data_dims(cfg, mesh)
    for g, rows in enumerate(batch):
        sub = mesh.group(g)
        views = fsdp.group_views(ranks, mesh, g, ddims)
        for v in views:
            for k in list(v):
                if k != "backbone":
                    v[k] = fsdp.View(fsdp.materialize(v[k]), v.device)
        with dctx.use(dctx.DistContext(sub if sub.size > 1 else None,
                                       ctx.fusion_mode)):
            logits, stats = _forward(views, rows, cfg)
        yield logits, stats, rows


def forward(params, batch, cfg):
    """Full forward: returns (logits (B, L, V) bf16, aux_loss), L the
    rows of :func:`embed_inputs` (the vlm's patches and tokens). Over W
    ranks (``params`` a list of per-rank :class:`LM`): per-rank logits
    (:func:`logits_fn`). Over data groups (``batch`` one a group,
    ``data.pipeline.shard_batch``): one list of per-rank logits for
    every rank of the mesh, each group's on its rows, and the aux
    loss over the global batch (``moe.global_aux``)."""
    if _data_mesh() is not None:
        logits, stats = [], []
        for lg, st, _ in _groups(params, batch, cfg):
            logits += lg
            stats.append(st)
        return logits, _aux(stats, logits[0].device)
    logits, stats = _forward(as_ranks(params), batch, cfg)
    return ((logits if isinstance(params, list) else logits[0]),
            _aux([stats], logits[0].device))


def _aux(stats: list, dev):
    """The aux loss of the data groups' MoE statistics (one group's on a
    model-only mesh; ``moe.global_aux``), 0.0 without MoE layers, on
    ``dev``."""
    aux = moe.global_aux(stats)
    return (torch.zeros((), dtype=torch.float32, device=dev) if aux is None
            else aux.to(dev))


def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Mean token cross-entropy in fp32 with z-loss; labels -100 (any
    negative) and mask entries <= 0 are ignored."""
    total, count = _ce_sum(logits.float(), labels, mask, z_loss)
    return total / count.clamp_min(1)


def _ce_sum(lf, labels, mask, z_loss):
    """(the sum of the token losses, the count of counted tokens) of
    fp32 logits ``lf``: :func:`cross_entropy`'s terms."""
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    return torch.where(valid, ce, 0.0).sum(), valid.sum()


def cross_entropy_ranks(logits, labels, vocab_size: int, mask=None,
                        z_loss: float = 1e-4):
    """:func:`cross_entropy` of per-rank vocab shards (B, S, V/W), rank r
    holding vocab entries [r V/W, (r+1) V/W): each rank's max and sum of
    exponentials combined across the ranks into the global logsumexp,
    the gold logit from the rank that owns the label, the z-loss on the
    global lse. Logits replicated by the rules ((B, S, V) on every rank)
    take rank 0's. Returns the loss on rank 0's device."""
    total, count = _ce_terms_ranks(logits, labels, vocab_size, mask, z_loss)
    return total / count.clamp_min(1)


def _ce_terms_ranks(logits, labels, vocab_size: int, mask=None,
                    z_loss: float = 1e-4):
    """:func:`cross_entropy_ranks`' (sum of the token losses, count of
    counted tokens) on rank 0's device, which data groups add up
    (:func:`loss_fn`)."""
    dev = logits[0].device
    if logits[0].shape[-1] == vocab_size:
        return _ce_sum(logits[0].float(), labels.to(dev), mask, z_loss)
    lf = [x.float() for x in logits]
    m = torch.stack([cm.to_device(x.amax(dim=-1), dev) for x in lf]).amax(
        dim=0).detach()
    sumexp = None
    gold = None
    lab = labels.long()
    for r, x in enumerate(lf):
        n = x.shape[-1]
        se = (x - cm.to_device(m, x.device)[..., None]).exp().sum(dim=-1)
        idx = lab.to(x.device).clamp_min(0) - r * n
        own = (idx >= 0) & (idx < n)
        g = torch.gather(x, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        g = torch.where(own, g, 0.0)
        se, g = cm.to_device(se, dev), cm.to_device(g, dev)
        sumexp = se if sumexp is None else sumexp + se
        gold = g if gold is None else gold + g
    lse = m + sumexp.log()
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    labels = labels.to(dev)
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask.to(dev) > 0)
    return torch.where(valid, ce, 0.0).sum(), valid.sum()


def loss_fn(params, batch, cfg, aux_weight: float = 0.01):
    """(loss, {"ce", "aux"}) of one batch ({"tokens", "labels"} (B, S),
    plus "patches" (vlm) or "frames" in place of "tokens" (audio)). The
    vlm's patch rows take no loss: their labels are -100, put in front
    of the batch's (JAX's pad). Over W ranks (``params`` a list of
    per-rank :class:`LM`) the whole batch goes to every rank and the
    loss lies on rank 0's device.

    Over a mesh with data groups (``pod`` x ``data`` > 1; ``params``
    one :class:`LM` a rank of the mesh, ``shard_params``; ``batch``
    one a group, ``data.pipeline.shard_batch``) each group runs the
    W-rank path on its rows (:func:`_groups`), and the loss is
    JAX's global mean: the groups' token-loss sums over all counted
    tokens (where the rows do not divide, every group runs the whole
    batch, and the sums' D copies over D times the count give the one
    mean and a gradient of the right size); the aux loss is
    ``moe.global_aux`` of the groups' statistics."""
    if _data_mesh() is not None:
        tot = cnt = None
        stats = []
        dev = as_ranks(params)[0].device
        for logits, st, rows in _groups(params, batch, cfg):
            s_, n_ = _ce_terms_ranks(
                logits, _pad_labels(rows["labels"], logits), cfg.vocab_size)
            s_, n_ = cm.to_device(s_, dev), cm.to_device(n_, dev)
            tot = s_ if tot is None else tot + s_
            cnt = n_ if cnt is None else cnt + n_
            stats.append(st)
        loss = tot / cnt.clamp_min(1)
        aux = _aux(stats, loss.device)
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}
    logits, stats = _forward(as_ranks(params), batch, cfg)
    labels = _pad_labels(batch["labels"], logits)
    loss = cross_entropy_ranks(logits, labels, cfg.vocab_size)
    aux = _aux([stats], loss.device)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _pad_labels(labels, logits):
    """``labels`` with -100 in front for the vlm's patch rows (JAX's
    pad: no loss on them)."""
    pad = logits[0].shape[1] - labels.shape[1]
    if pad:
        labels = torch.cat([torch.full((labels.shape[0], pad), -100,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    return labels


def replicate(params, mesh) -> list:
    """The parameters on every distinct device of ``mesh``: ``params``
    itself on its own device, a copy on each other one (virtual ranks on
    one card share one copy)."""
    out = []
    for d in mesh.distinct:
        if d == params.device:
            out.append(params)
            continue
        tree: dict = {}
        for name, t in params.named_parameters():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().to(d)
        out.append(LM(params.cfg, tree))
    return out


# ------------------------------------------------------------------ decode
def _mesh():
    """The ambient mesh when it has more than one rank, else None."""
    ctx = dctx.current()
    return ctx.mesh if ctx.model_axis_size > 1 else None


def _per_device(value):
    return value if isinstance(value, list) else [value]


def _lists(trees: list):
    """One tree of per-device lists from a list of per-device trees (None
    stays None)."""
    if trees[0] is None:
        return None
    return {k: _lists([t[k] for t in trees]) if isinstance(v, dict)
            else [t[k] for t in trees] for k, v in trees[0].items()}


def _mesh_caches(cfg, mesh, batch: int, kv_shard):
    """The caches tree over ``mesh``: ``kv_shard(device)`` on every rank
    (per-rank lists), the recurrent state once per distinct device; over
    data groups once per (group, device) (``Mesh.holders``), each
    copy its group's rows (``Mesh.rows``)."""
    return transformer.assemble(
        cfg, _lists([kv_shard(d) for d in mesh.devices]),
        _lists([transformer.recurrent_state(
            cfg, _n_rows(mesh.rows(g, batch)), cfg.dtype, d)
            for g, d in mesh.holders]))


def _n_rows(rows: slice) -> int:
    return rows.stop - rows.start


def _state_mesh():
    """The ambient mesh that lays out a decode state: one with data
    groups, or several model ranks; else None (one rank)."""
    return _data_mesh() or _mesh()


def init_paged_decode_state(params, cfg, batch: int, n_blocks: int,
                            block_size: int, max_blocks: int):
    """Paged decode state: KV pools (kv_layers, n_blocks, block_size,
    KVH, hd) and the per-slot recurrent state (layers, B, ...) of the
    block (``transformer.init_paged_caches``) in ``cfg.dtype`` (fp32 SSM
    and WKV states), per-slot ``cur_len`` (B,) int32 and
    ``block_tables`` (B, max_blocks) int32 (-1 = unallocated), on the
    parameters' device.

    Over the W ranks of the ambient mesh the pools are per-rank lists of
    (kv_layers, n_blocks / W, ...) shards (rank r holds global blocks
    [r * n_blocks / W, (r + 1) * n_blocks / W)), and the recurrent
    state, ``cur_len`` and ``block_tables`` are lists with one copy per
    distinct device. Over a mesh with data groups W is every rank of it
    (the D x M ranks share one pool, each ``sharding_rules.pool_blocks``
    of it: a count that does not divide is padded with blocks no table
    names), and the recurrent state is one copy per (group, device),
    of the group's rows (``Mesh.holders``, ``Mesh.rows``)."""
    mesh = _state_mesh()
    devs = [device_of(params)] if mesh is None else list(mesh.distinct)
    if mesh is None:
        caches = transformer.init_paged_caches(
            cfg, batch, n_blocks, block_size, cfg.dtype, device=devs[0])
    else:
        if mesh.dp == 1 and n_blocks % mesh.size:
            raise ValueError(f"n_blocks={n_blocks} must divide by the "
                             f"{mesh.size} ranks (CachePool rounds up)")
        n_loc, _ = sr.pool_blocks(n_blocks, mesh.size)
        caches = _mesh_caches(
            cfg, mesh, batch, lambda d: transformer.paged_kv(
                cfg, n_loc, block_size, cfg.dtype, d))
    state = {"caches": caches,
             "cur_len": [torch.zeros((batch,), dtype=torch.int32, device=d)
                         for d in devs],
             "block_tables": [torch.full((batch, max_blocks), -1,
                                         dtype=torch.int32, device=d)
                              for d in devs]}
    if mesh is None:
        state["cur_len"], = state["cur_len"]
        state["block_tables"], = state["block_tables"]
    return state


def init_decode_state(params, cfg, batch: int, max_len: int):
    """Contiguous decode state: per-layer KV caches (kv_layers, B, S_max,
    KVH, hd) and the per-slot recurrent state in ``cfg.dtype``, and
    per-slot ``cur_len`` (B,) int32 -- each slot advances independently.
    Over the W ranks of the ambient mesh the KV caches are per-rank
    lists of strided shards (kv_layers, B, S_max / W, KVH, hd) (local
    slot j of rank r holds position j * W + r), the recurrent state and
    ``cur_len`` one copy per distinct device. Over data groups (JAX's
    ``decode_state_shardings``: the batch on ``("pod", "data")``, the
    sequence on ``model``) rank (g, m) holds group g's rows (``Mesh.rows``:
    B / dp of them, or all B where B does not divide) of the strided
    shard over the group's M ranks, and the recurrent state is one copy
    per (group, device) of the group's rows."""
    mesh = _state_mesh()
    if mesh is None:
        dev = device_of(params)
        return {"caches": transformer.init_caches(
                    cfg, batch, max_len, cfg.dtype, device=dev),
                "cur_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)}
    b = _n_rows(mesh.rows(0, batch))
    return {"caches": _mesh_caches(cfg, mesh, batch,
                                   lambda d: transformer.contiguous_kv(
                                       cfg, b, max_len, cfg.dtype, d,
                                       W=mesh.model)),
            "cur_len": [torch.zeros((batch,), dtype=torch.int32, device=d)
                        for d in mesh.distinct]}


def set_slot_len(state, slot: int, n: int):
    """Set one slot's position counter, in place (``fill_``: a Python
    int stored with ``cl[slot] = n`` would go up as a CPU scalar through
    a synchronising copy)."""
    for cl in _per_device(state["cur_len"]):
        cl[slot].fill_(n)
    return state


def copy_cache_block(state, cfg, src: int, dst: int):
    """Device half of copy-on-write: clone pool block src -> dst across
    all attention layers (and across ranks over a mesh), in place;
    recurrent state is untouched."""
    transformer.copy_paged_block(cfg, state["caches"], src, dst)
    return state


def _leaf_lists(tree) -> list:
    """Every leaf of a state tree: a tensor, or its list of per-rank
    (per-copy) tensors."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_lists(v)]
    return [] if tree is None else [tree]


def _zero_slot(tree, slot: int, batch: int):
    """Zero one slot of every leaf of ``tree`` (the slot at dim 1), in
    place; over data groups in each copy of the slot's group, at its row
    there (``Mesh.rows``): a list of ``mesh.size`` entries is per rank
    (rank r in group r // M), another per ``Mesh.holders`` entry (the
    two agree where both lengths are equal: every rank on its own
    device)."""
    mesh = _data_mesh()
    for leaf in _leaf_lists(tree):
        for i, t in enumerate(_per_device(leaf)):
            if mesh is None:
                t[:, slot].zero_()
                continue
            g = (i // mesh.model if len(leaf) == mesh.size
                 else mesh.holders[i][0])
            rows = mesh.rows(g, batch)
            if rows.start <= slot < rows.stop:
                t[:, slot - rows.start].zero_()


def _batch(state) -> int:
    return _per_device(state["cur_len"])[0].shape[0]


def reset_slot(state, slot: int):
    """Contiguous admission reset: zero one slot's caches (every leaf has
    the slot at dim 1) and position, in place."""
    _zero_slot(state["caches"], slot, _batch(state))
    return set_slot_len(state, slot, 0)


def reset_slot_paged(state, cfg, slot: int):
    """Paged admission reset: zero the slot's recurrent state (the
    hybrid's and rwkv's leaves, slot at dim 1) and position, in place.
    Paged KV blocks need no zeroing: stale block contents sit beyond
    cur_len and are masked."""
    _zero_slot(transformer.recurrent_part(cfg, state["caches"]), slot,
               _batch(state))
    return set_slot_len(state, slot, 0)


def release_slot_paged(state, slot: int):
    """Preemption reset: zero the slot's position the moment its blocks
    are freed, so it never points past blocks now owned by others (its
    recurrent state resets at the next admission)."""
    return set_slot_len(state, slot, 0)


def _device_lists(tree):
    """``tree`` with every tensor leaf made a list of one (W = 1)."""
    if isinstance(tree, dict):
        return {k: _device_lists(v) for k, v in tree.items()}
    return _per_device(tree)


class StepRanks(NamedTuple):
    """Parameters as the decode step reads them (:func:`step_ranks`):
    one per rank (on a data mesh data group 0's views), and the
    :func:`split_axes` tree they hold. Their owner builds them once
    (``Engine``) and passes them where :func:`decode_step` and its
    callers take ``params``."""
    ranks: list
    split: dict


def step_ranks(params, cfg) -> StepRanks:
    """``params`` as one :class:`LM` per rank of the ambient mesh, and
    the :func:`split_axes` tree they hold (a :class:`StepRanks` as it
    is): a list of ``mesh.size``
    shards (:func:`shard_params`) is per rank and split as its
    ``split`` says; whole weights (an :class:`LM`: one rank, or every
    rank's replica on one card; a per-device list, :func:`replicate`,
    repeated for the ranks of each device) hold every leaf whole. Over a
    mesh with data groups only shards serve (the weights' ``embed`` dim
    is cut over ``data``), as data group 0's per-model-rank views
    (:func:`_stationary_views`)."""
    if isinstance(params, StepRanks):
        return params
    ps = _per_device(params)
    data = _data_mesh()
    split = ps[0].split
    if data is not None:
        if split is None or not isinstance(params, list) \
                or len(ps) != data.size:
            raise ValueError(
                f"{len(ps)} parameter trees "
                f"({'shards' if split else 'whole'}) for a mesh of "
                f"{data.size} ranks with {data.dp} data groups: decode on "
                f"a data mesh takes lm.shard_params(params, mesh), one per "
                f"rank (the weights' embed dim stays cut over data)")
        return StepRanks(_stationary_views(ps, data, cfg), split)
    mesh = _mesh()
    W, n_dev = (1, 1) if mesh is None else (mesh.size, len(mesh.distinct))
    if split is not None and isinstance(params, list) and len(ps) == W:
        return StepRanks(ps, split)
    if split is None and len(ps) == n_dev:
        return StepRanks(ps if mesh is None else mesh.per_rank(ps),
                         _whole(cfg))
    raise ValueError(f"{len(ps)} parameter trees "
                     f"({'shards' if split else 'whole'}) for a mesh of "
                     f"{W} ranks on {n_dev} devices: pass "
                     f"lm.shard_params(params, mesh) (one per rank) or "
                     f"lm.replicate(params, mesh) (one per device)")


def _stationary_views(ps: list, mesh, cfg) -> list:
    """The weights-stationary decode's parameters over a mesh with data
    groups: one ``fsdp.View`` per model rank m of data group 0 (the
    ranks that run the weight sites), each leaf that the ``data`` axis
    cuts the ``cm.Stationary`` of its D blocks (ranks (0, g, m) of the
    first pod: the pods hold copies), every other leaf rank m's own.
    Nothing is gathered or copied: the views wrap the shards' tensors."""
    M, D = mesh.model, mesh.axis_size("data")
    ddims = data_dims(cfg, mesh)
    views = []
    for m in range(M):
        peers = [dict(ps[g * M + m].named_parameters()) for g in range(D)]
        tree: dict = {}
        for name, t in peers[0].items():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            dim = ddims[name]
            node[leaf] = t if dim is None else cm.Stationary(
                [p[name] for p in peers], dim)
        views.append(fsdp.View(tree, ps[m].device))
    return views


def _embed_decode(ps, token, cfg, axis):
    """The decode step's input (B, 1, d) in ``cfg.dtype`` once per
    distinct device, from per-rank ``ps`` whose input table the model
    axis splits along ``axis`` (:func:`split_axes`): the fp32 gather of
    JAX's decode, in the table's layout (:func:`_embed_ranks`): whole,
    gathered on each device; its columns sharded, each rank's columns
    all-gathered; its rows sharded (``in_vocab``: paligemma), each
    rank's masked gather summed over the ranks in rank order. Cast, then
    rwkv's ``ln_in``, as JAX's decode orders them."""
    mesh = _mesh()
    dev = dctx.by_device(ps)
    if axis is None:
        x = [apply_embed(p["embed"], token.to(p.device), torch.float32)
             for p in dev]
    else:
        g = [_gather(p, token, cfg, r) for r, p in enumerate(ps)]
        x = (cm.all_reduce_devices(g, mesh.distinct) if axis == "in_vocab"
             else cm.all_gather_devices(g, mesh.distinct, gather_axis=-1))
    x = [t.to(cfg.dtype) for t in x]
    if cfg.block == "rwkv":
        x = [apply_norm(p["ln_in"], t, "layernorm") for p, t in zip(dev, x)]
    return x


def _logits_decode(ps, x, cfg, split):
    """The final norm once per device and the unembed: one (B, 1, V)
    bf16 tensor on the first device. A whole head runs once there; vocab
    shards (``logits_fn``, one product a rank) are gathered along the
    vocab onto it, for the sampler."""
    dev = dctx.by_device(ps)
    axis = split["embed" if cfg.tie_embeddings else "head"]["table"]
    if axis is None:
        return logits_fn(dev[0], apply_norm(dev[0]["ln_f"], x[0], cfg.norm),
                         cfg)
    if axis not in ("vocab", "in_vocab"):
        raise NotImplementedError(f"decode's unembed over a head split "
                                  f"along {axis!r}")
    h = [apply_norm(p["ln_f"], xd, cfg.norm) for p, xd in zip(dev, x)]
    parts = logits_fn(ps, _mesh().per_rank(h), cfg, seq_sharded=False)
    return cm.all_gather_devices(parts, [h[0].device], gather_axis=-1)[0]


def decode_step(params, token, state, cfg, active=None,
                gather_width: int | None = None, bounded: bool = True):
    """token: (B, 1) int; one autoregressive step over the paged state
    (``init_paged_decode_state``) or the contiguous one
    (``init_decode_state``). Returns (logits (B, 1, V) bf16 on the first
    device, state) with ``state`` updated IN PLACE.

    ``params``: an :class:`LM`; over a mesh with several ranks, per-rank
    shards (:func:`shard_params`: a list of ``mesh.size``, JAX's serve
    step on ``param_shardings``) or one replica per distinct device
    (:func:`replicate`); the decode sites read how they are split from
    :func:`split_axes` (``transformer.decode``). ``active`` (B,) bool:
    slots that consume a token this step; inactive slots keep their KV
    entries and ``cur_len`` byte-identical. ``None`` means all slots
    step.

    Gather-width contract (paged): the attention sees only the leading
    ``[:, :gather_width]`` slice of the block table, which must cover
    every allocated entry of every active slot (the serving layer passes
    ``CachePool.gather_width()``); ``None`` means the full table.
    ``bounded`` (paged, W > 1): the table walk (default) or the masked
    whole-shard oracle (CPU only)."""
    ps, split = step_ranks(params, cfg)
    data = _data_mesh()
    if data is None:
        return _decode_step(ps, split, token, state, cfg, active,
                            gather_width, bounded)
    sub = data.group(0)
    with dctx.use(dctx.DistContext(sub if sub.size > 1 else None,
                                   dctx.current().fusion_mode, data)):
        return _decode_step(ps, split, token, state, cfg, active,
                            gather_width, bounded)


def _decode_step(ps, split, token, state, cfg, active, gather_width,
                 bounded):
    """:func:`decode_step` on per-rank parameters ``ps`` (data group 0's
    views over a data mesh, under its model sub-mesh: ``DistContext.data``
    holds the whole mesh, which the KV caches and the recurrent state
    are laid out on)."""
    cur_len = _per_device(state["cur_len"])
    B = token.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=token.device)
    act = [active.to(c.device) for c in cur_len]
    for c, a in zip(cur_len, act):
        c += a.to(torch.int32)            # includes the new token
    x = _embed_decode(ps, token, cfg, split["embed"]["table"])
    bt = state.get("block_tables")
    btg = None if bt is None else [
        b if gather_width is None else b[:, :gather_width]
        for b in _per_device(bt)]
    caches = _device_lists(state["caches"])
    x = transformer.decode([p["backbone"] for p in ps], x, caches, cur_len,
                           cfg, act, btg, bounded, split=split["backbone"])
    return _logits_decode(ps, x, cfg, split), state


def decode_chunk(params, tokens, counts, state, cfg,
                 gather_width: int | None = None, bounded: bool = True):
    """Chunked batched prefill: consume up to C tokens per slot.

    tokens: (B, C) int — each slot's next tokens, left-aligned;
    counts: (B,) int — how many of the C are real (0 = idle slot).
    Returns (logits (B, 1, V) fp32 from each slot's LAST consumed token,
    zeros for count 0, state updated in place). ``gather_width`` and
    ``bounded`` follow :func:`decode_step`; the width must cover the
    whole chunk."""
    B, C = tokens.shape
    logits = torch.zeros((B, 1, cfg.vocab_size), dtype=torch.float32,
                         device=tokens.device)
    for j in range(C):
        act = counts > j
        lg, state = decode_step(params, tokens[:, j:j + 1], state, cfg,
                                active=act, gather_width=gather_width,
                                bounded=bounded)
        logits = torch.where(act[:, None, None], lg.float(), logits)
    return logits, state


def decode_multi(params, token, state, cfg, *, steps: int, budgets,
                 sample_fn, gather_width: int | None = None,
                 bounded: bool = True):
    """K-step decode megatick: ``steps`` autoregressive
    :func:`decode_step` calls with in-loop sampling, each step's sampled
    token fed to the next without leaving the device (a Python loop;
    captured in a CUDA graph it is one replay).

    token: (B, 1) int32, each slot's last token; budgets: (B,) int32,
    how many of the steps each slot runs (a slot past its budget is
    frozen byte-identically, like an inactive slot of
    :func:`decode_step`); sample_fn: ``(logits (B, 1, V), j) -> (B, 1)
    int32``, the sampler of step ``j``. Returns (tokens (B, steps)
    int32, state); row b is valid up to ``budgets[b]`` tokens, later
    entries repeat its last valid one. ``gather_width`` must cover every
    block the whole megatick writes."""
    tok, out = token, []
    for j in range(steps):
        act = budgets > j
        logits, state = decode_step(params, tok, state, cfg, active=act,
                                    gather_width=gather_width,
                                    bounded=bounded)
        tok = torch.where(act[:, None], sample_fn(logits, j), tok)
        out.append(tok[:, 0])
    return torch.stack(out, dim=1), state


def decode_mixed(params, tokens, token0, prefill_lens, emit_from, totals,
                 state, cfg, *, steps: int, sample_fn,
                 gather_width: int | None = None, bounded: bool = True):
    """Mixed prefill+decode megatick: ``steps`` :func:`decode_step` calls
    in which slot b's step j consumes prompt token ``tokens[b, j]``
    while ``j < prefill_lens[b]``, then the carry token (the previously
    sampled one; ``token0`` seeds it), and is frozen from
    ``totals[b]`` on. Sampling feeds the carry on steps ``emit_from[b]
    <= j < totals[b]`` (the engine sets ``emit_from`` to the step that
    consumes the last prompt token, so the first output token rides its
    logits, or to ``totals`` for a slot still mid-prompt).

    tokens: (B, S) int32 prompt tokens, left-aligned; token0: (B, 1)
    int32; prefill_lens, emit_from, totals: (B,) int32. Returns (out
    (B, steps) int32, state); row b's emitted tokens are
    ``out[b, emit_from[b]:totals[b]]``."""
    tok, out = token0, []
    for j in range(steps):
        act = totals > j
        inp = torch.where((prefill_lens > j)[:, None], tokens[:, j:j + 1],
                          tok)
        logits, state = decode_step(params, inp, state, cfg, active=act,
                                    gather_width=gather_width,
                                    bounded=bounded)
        emit = (emit_from <= j) & act
        tok = torch.where(emit[:, None], sample_fn(logits, j), tok)
        out.append(tok[:, 0])
    return torch.stack(out, dim=1), state
