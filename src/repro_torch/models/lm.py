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
rank's shards (:func:`shard_params`, Megatron-style by the sharding
rules: attention heads, MLP columns and the vocab split over the ranks,
the input table's columns too, or its rows where a config's overrides
say so (paligemma's tied table); norm scales and ``frontend_proj``
copied to every rank) and
run the paper's sequence-parallel AG+GEMM and GEMM+RS at the projection
sites (``core.patterns``); the loss is vocab-parallel
(:func:`cross_entropy_ranks`).

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

from typing import Any

import torch
from torch import nn

from repro_torch.core import collective_matmul as cm
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models import transformer
from repro_torch.models.layers import (apply_embed, apply_norm, apply_unembed,
                                       dense, embed_spec, norm_spec)
from repro_torch.models.module import Param, init_tree, tree_items


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
    """Parameter tree of a decoder LM, keyed like the JAX tree."""

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
    """Seeded random init from :func:`lm_spec` (a ``torch.Generator`` on
    ``device``; no weights are read from anywhere); ``trainable`` gives
    fp32 masters that require grad. With a ``mesh`` of W > 1 ranks: the
    same numbers, sharded (:func:`shard_params`), drawn on the first
    rank's device."""
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    tree = init_tree(lm_spec(cfg), seed=seed, device=dev,
                     cast=lambda path, x: x.to(_dtype(path, cfg, trainable)))
    params = LM(cfg, tree, trainable)
    if mesh is None or mesh.size == 1:
        return params
    return shard_params(params, mesh)


def shard_dims(cfg, mesh) -> dict:
    """``{dotted path: the dim the model axis shards, or None}`` of every
    parameter leaf for ``mesh`` (``sharding_rules.rules_for``)."""
    return sr.shard_dims(lm_spec(cfg), sr.rules_for(cfg, mesh))


def shard_params(params: LM, mesh) -> list:
    """The per-rank :class:`LM` of ``params`` over ``mesh``: rank r on
    ``mesh.devices[r]`` holds block r of every sharded leaf and its own
    copy of every replicated one (also where ranks share a card, so the
    same code runs on virtual and real ranks). Trainable stays
    trainable. Every block: the expert, ``ssm_inner`` and ``mlp`` dims
    split as the rules say (serving replicates instead,
    :func:`replicate`)."""
    cfg = params.cfg
    trainable = any(p.requires_grad for p in params.parameters())
    trees = sr.shard_tree(param_tree(params), lm_spec(cfg),
                          sr.rules_for(cfg, mesh), devices=mesh.devices)
    return [LM(cfg, t, trainable) for t in trees]


def gather_params(shards: list, mesh) -> LM:
    """The global :class:`LM` of per-rank ``shards`` (inverse of
    :func:`shard_params`) on rank 0's device."""
    cfg = shards[0].cfg
    trainable = any(p.requires_grad for p in shards[0].parameters())
    tree = sr.unshard_tree([param_tree(p) for p in shards], lm_spec(cfg),
                           sr.rules_for(cfg, mesh))
    return LM(cfg, tree, trainable)


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
    """Per-rank logits and the aux loss of the per-rank ``ranks``."""
    W = dctx.current().model_axis_size
    if len(ranks) != W:
        raise ValueError(f"{len(ranks)} per-rank parameter trees for a "
                         f"mesh of {W} ranks: run under dctx.use("
                         f"DistContext(mesh, ...)) with lm.shard_params("
                         f"params, mesh)")
    x, positions, _ = embed_inputs(ranks, batch, cfg)
    x, aux = transformer.forward([p["backbone"] for p in ranks], x, cfg,
                                 positions=positions)
    x = [apply_norm(p["ln_f"], xr, cfg.norm) for p, xr in zip(ranks, x)]
    return logits_fn(ranks, x, cfg, seq_sharded=positions.shape[-1]
                     % len(ranks) == 0), aux


def forward(params, batch, cfg):
    """Full forward: returns (logits (B, L, V) bf16, aux_loss), L the
    rows of :func:`embed_inputs` (the vlm's patches and tokens). Over W
    ranks (``params`` a list of per-rank :class:`LM`): per-rank logits
    (:func:`logits_fn`)."""
    logits, aux = _forward(as_ranks(params), batch, cfg)
    return (logits if isinstance(params, list) else logits[0]), aux


def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Mean token cross-entropy in fp32 with z-loss; labels -100 (any
    negative) and mask entries <= 0 are ignored."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / valid.sum().clamp_min(1)


def cross_entropy_ranks(logits, labels, vocab_size: int, mask=None,
                        z_loss: float = 1e-4):
    """:func:`cross_entropy` of per-rank vocab shards (B, S, V/W), rank r
    holding vocab entries [r V/W, (r+1) V/W): each rank's max and sum of
    exponentials combined across the ranks into the global logsumexp,
    the gold logit from the rank that owns the label, the z-loss on the
    global lse. Logits replicated by the rules ((B, S, V) on every rank)
    take rank 0's. Returns the loss on rank 0's device."""
    dev = logits[0].device
    if logits[0].shape[-1] == vocab_size:
        return cross_entropy(logits[0], labels.to(dev), mask, z_loss)
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
    ce = torch.where(valid, ce, 0.0)
    return ce.sum() / valid.sum().clamp_min(1)


def loss_fn(params, batch, cfg, aux_weight: float = 0.01):
    """(loss, {"ce", "aux"}) of one batch ({"tokens", "labels"} (B, S),
    plus "patches" (vlm) or "frames" in place of "tokens" (audio)). The
    vlm's patch rows take no loss: their labels are -100, put in front
    of the batch's (JAX's pad). Over W ranks (``params`` a list of
    per-rank :class:`LM`) the whole batch goes to every rank and the
    loss lies on rank 0's device."""
    logits, aux = _forward(as_ranks(params), batch, cfg)
    labels = batch["labels"]
    pad = logits[0].shape[1] - labels.shape[1]
    if pad:
        labels = torch.cat([torch.full((labels.shape[0], pad), -100,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    loss = cross_entropy_ranks(logits, labels, cfg.vocab_size)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


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


def _leaves(tree):
    """Every tensor of a state tree (lists of per-device copies
    included)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def _mesh_caches(cfg, mesh, batch: int, kv_shard):
    """The caches tree over ``mesh``: ``kv_shard(device)`` on every rank
    (per-rank lists), the recurrent state once per distinct device."""
    return transformer.assemble(
        cfg, _lists([kv_shard(d) for d in mesh.devices]),
        _lists([transformer.recurrent_state(cfg, batch, cfg.dtype, d)
                for d in mesh.distinct]))


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
    distinct device."""
    mesh = _mesh()
    devs = [params.device] if mesh is None else list(mesh.distinct)
    if mesh is None:
        caches = transformer.init_paged_caches(
            cfg, batch, n_blocks, block_size, cfg.dtype, device=devs[0])
    else:
        if n_blocks % mesh.size:
            raise ValueError(f"n_blocks={n_blocks} must divide by the "
                             f"{mesh.size} ranks (CachePool rounds up)")
        caches = _mesh_caches(
            cfg, mesh, batch, lambda d: transformer.paged_kv(
                cfg, n_blocks // mesh.size, block_size, cfg.dtype, d))
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
    ``cur_len`` one copy per distinct device."""
    mesh = _mesh()
    if mesh is None:
        return {"caches": transformer.init_caches(
                    cfg, batch, max_len, cfg.dtype, device=params.device),
                "cur_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=params.device)}
    return {"caches": _mesh_caches(cfg, mesh, batch,
                                   lambda d: transformer.contiguous_kv(
                                       cfg, batch, max_len, cfg.dtype, d,
                                       W=mesh.size)),
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


def _zero_slot(tree, slot: int):
    for leaf in _leaves(tree):
        leaf[:, slot].zero_()


def reset_slot(state, slot: int):
    """Contiguous admission reset: zero one slot's caches (every leaf has
    the slot at dim 1) and position, in place."""
    _zero_slot(state["caches"], slot)
    return set_slot_len(state, slot, 0)


def reset_slot_paged(state, cfg, slot: int):
    """Paged admission reset: zero the slot's recurrent state (the
    hybrid's and rwkv's leaves, slot at dim 1) and position, in place.
    Paged KV blocks need no zeroing: stale block contents sit beyond
    cur_len and are masked."""
    _zero_slot(transformer.recurrent_part(cfg, state["caches"]), slot)
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


def decode_step(params, token, state, cfg, active=None,
                gather_width: int | None = None, bounded: bool = True):
    """token: (B, 1) int; one autoregressive step over the paged state
    (``init_paged_decode_state``) or the contiguous one
    (``init_decode_state``). Returns (logits (B, 1, V) bf16 on the first
    device, state) with ``state`` updated IN PLACE.

    ``params``: an :class:`LM`, or over a mesh with several distinct
    devices one per device (:func:`replicate`). ``active`` (B,) bool:
    slots that consume a token this step; inactive slots keep their KV
    entries and ``cur_len`` byte-identical. ``None`` means all slots
    step.

    Gather-width contract (paged): the attention sees only the leading
    ``[:, :gather_width]`` slice of the block table, which must cover
    every allocated entry of every active slot (the serving layer passes
    ``CachePool.gather_width()``); ``None`` means the full table.
    ``bounded`` (paged, W > 1): the table walk (default) or the masked
    whole-shard oracle (CPU only)."""
    cur_len = _per_device(state["cur_len"])
    ps = _per_device(params)
    if len(ps) != len(cur_len):
        raise ValueError(f"{len(ps)} parameter replicas for "
                         f"{len(cur_len)} devices: pass lm.replicate("
                         f"params, mesh)")
    B = token.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=token.device)
    act = [active.to(c.device) for c in cur_len]
    for c, a in zip(cur_len, act):
        c += a.to(torch.int32)            # includes the new token
    x = [apply_embed(p["embed"], token.to(c.device), torch.float32)
         .to(cfg.dtype) for p, c in zip(ps, cur_len)]
    if cfg.block == "rwkv":
        x = [apply_norm(p["ln_in"], xd, "layernorm") for p, xd in zip(ps, x)]
    bt = state.get("block_tables")
    btg = None if bt is None else [
        b if gather_width is None else b[:, :gather_width]
        for b in _per_device(bt)]
    caches = _device_lists(state["caches"])
    x = transformer.decode([p["backbone"] for p in ps], x, caches, cur_len,
                           cfg, act, btg, bounded)
    h = apply_norm(ps[0]["ln_f"], x[0], cfg.norm)
    return logits_fn(ps[0], h, cfg), state


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
