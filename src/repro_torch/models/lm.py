"""Top-level LM and its paged decode entry points (port of
``repro.models.lm``).

:class:`LM` is an ``nn.Module`` holding the parameter tree keyed like the
JAX tree (``embed.table``, ``backbone.layers.attn.wq``, ``ln_f.scale``,
``head.table``); it indexes like the JAX dict (``params["backbone"]``),
so the functional decode code reads either. Storage dtypes: weight
matrices and the input embedding in ``cfg.dtype`` (what JAX's per-call
``.astype(x.dtype)`` computes with), norm scales and the output head in
fp32 (JAX's unembed promotes a bf16 ``x`` against the fp32 head table,
so the logits are an fp32 product).

Decode state is a dict ``{"caches": {"k", "v"}, "cur_len", "block_tables"}``
as in JAX, but the entry points update it IN PLACE (KV pools, ``cur_len``)
and return the same dict, where JAX returns new arrays.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (apply_embed, apply_norm, apply_unembed,
                                       embed_spec, norm_spec)
from repro_torch.models.module import Param, init_tree, tree_items


def lm_spec(cfg):
    transformer.require_attn_mlp(cfg)
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} frontend is not ported yet "
            f"(other-families slice of the port)")
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "backbone": transformer.stack_spec(cfg),
        "ln_f": norm_spec(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        spec["head"] = {"table": Param((cfg.vocab_size, cfg.d_model),
                                       init="scaled",
                                       axes=("vocab", "embed"))}
    return spec


def storage_dtype(path: str, cfg) -> torch.dtype:
    """How the port stores the leaf at dotted ``path``."""
    leaf = path.rsplit(".", 1)[-1]
    if path == "head.table" or leaf in ("scale", "bias"):
        return torch.float32
    if path == "embed.table" and cfg.tie_embeddings:
        return torch.float32          # it is also the fp32 unembed table
    return cfg.dtype


def _module(tree: dict) -> nn.Module:
    if all(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _module(v) for k, v in tree.items()})
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    raise TypeError(f"mixed subtree {sorted(tree)}: a level holds either "
                    f"sub-dicts or tensors")


class LM(nn.Module):
    """Parameter tree of a decoder LM, keyed like the JAX tree."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        for k, v in tree.items():
            self.add_module(k, _module(v))

    def __getitem__(self, key: str):
        return self._modules[key]

    @property
    def device(self) -> torch.device:
        return self["embed"]["table"].device


def from_tree(cfg, tree: dict) -> LM:
    """Build an :class:`LM` from a nested dict of tensors, checking it
    against :func:`lm_spec` key for key and shape for shape, and casting
    every leaf to its storage dtype."""
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
                else v.to(storage_dtype(path, cfg))
        return out
    return LM(cfg, build(tree))


def init_params(cfg, *, seed: int = 0, device="cuda") -> LM:
    """Seeded random init from :func:`lm_spec` (a ``torch.Generator`` on
    ``device``; no weights are read from anywhere)."""
    dev = resolve_device(device)
    tree = init_tree(lm_spec(cfg), seed=seed, device=dev,
                     cast=lambda path, x: x.to(storage_dtype(path, cfg)))
    return LM(cfg, tree)


def logits_fn(params, x, cfg):
    """Unembed: fp32 product against the head (or tied embedding) table,
    logits cast to bf16 as in JAX."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["head"]["table"])
    return apply_unembed({"table": table}, x, dtype=torch.bfloat16)


# ------------------------------------------------------------------ decode
def init_paged_decode_state(params, cfg, batch: int, n_blocks: int,
                            block_size: int, max_blocks: int):
    """Paged decode state on the parameters' device: KV pools
    (layers, n_blocks, block_size, KVH, hd) in ``cfg.dtype``, per-slot
    ``cur_len`` (B,) int32 and ``block_tables`` (B, max_blocks) int32
    (-1 = unallocated)."""
    dev = params.device
    return {"caches": transformer.init_paged_caches(
                cfg, batch, n_blocks, block_size, cfg.dtype, device=dev),
            "cur_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "block_tables": torch.full((batch, max_blocks), -1,
                                       dtype=torch.int32, device=dev)}


def set_slot_len(state, slot: int, n: int):
    """Set one slot's position counter, in place."""
    state["cur_len"][slot] = n
    return state


def copy_cache_block(state, cfg, src: int, dst: int):
    """Device half of copy-on-write: clone pool block src -> dst across
    all layers, in place."""
    transformer.copy_paged_block(cfg, state["caches"], src, dst)
    return state


def reset_slot_paged(state, cfg, slot: int):
    """Paged admission reset. An attn_mlp model has no recurrent state,
    so only the position counter resets (stale pool blocks sit beyond
    cur_len and are masked)."""
    return set_slot_len(state, slot, 0)


def release_slot_paged(state, slot: int):
    """Preemption reset: zero the slot's position the moment its blocks
    are freed, so it never points past blocks now owned by others."""
    return set_slot_len(state, slot, 0)


def decode_step(params, token, state, cfg, active=None,
                gather_width: int | None = None):
    """token: (B, 1) int; one autoregressive step. Returns
    (logits (B, 1, V) bf16, state) with ``state`` updated IN PLACE.

    ``active`` (B,) bool: slots that consume a token this step; inactive
    slots keep their KV entries and ``cur_len`` byte-identical. ``None``
    means all slots step.

    Gather-width contract: the attention sees only the leading
    ``[:, :gather_width]`` slice of the block table, which must cover
    every allocated entry of every active slot (the serving layer passes
    ``CachePool.gather_width()``); ``None`` means the full table."""
    B = token.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=token.device)
    cur_len = state["cur_len"]
    cur_len += active.to(torch.int32)     # includes the new token
    x = apply_embed(params["embed"], token, torch.float32).to(cfg.dtype)
    bt = state["block_tables"]
    btg = bt if gather_width is None else bt[:, :gather_width]
    x = transformer.decode(params["backbone"], x, state["caches"], cur_len,
                           cfg, active, btg)
    x = apply_norm(params["ln_f"], x, cfg.norm)
    return logits_fn(params, x, cfg), state


def decode_chunk(params, tokens, counts, state, cfg,
                 gather_width: int | None = None):
    """Chunked batched prefill: consume up to C tokens per slot.

    tokens: (B, C) int — each slot's next tokens, left-aligned;
    counts: (B,) int — how many of the C are real (0 = idle slot).
    Returns (logits (B, 1, V) fp32 from each slot's LAST consumed token,
    zeros for count 0, state updated in place). ``gather_width``
    follows :func:`decode_step` and must cover the whole chunk."""
    B, C = tokens.shape
    logits = torch.zeros((B, 1, cfg.vocab_size), dtype=torch.float32,
                         device=tokens.device)
    for j in range(C):
        act = counts > j
        lg, state = decode_step(params, tokens[:, j:j + 1], state, cfg,
                                active=act, gather_width=gather_width)
        logits = torch.where(act[:, None, None], lg.float(), logits)
    return logits, state
