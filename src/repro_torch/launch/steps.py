"""Train / eval / serve step functions (port of ``repro.launch.steps``).

PyTorch runs eagerly, so a step is a plain function: the train step
runs the forward and the loss, the backward (every projection's
gradient through the GEMM kernel), and the AdamW update IN PLACE on the
parameters and the optimizer state, which it returns for the caller's
convenience. Over the W ranks of the ambient mesh
(``distributed.context``) the parameters are a list of per-rank LMs
(``lm.shard_params``) and the optimizer state a list of per-rank states
(:func:`init_opt_state`); one backward runs through every rank. A batch
holds what JAX's ``input_specs`` name for the model's family
(:func:`synthetic_batch`). :func:`input_specs`,
:func:`decode_state_specs` and :func:`param_specs` are JAX's
ShapeDtypeStruct stand-ins as meta tensors (shape and dtype, no
storage), which ``launch.dryrun`` makes fake tensors of.

The sharding trees are JAX's, as plain dicts (no ``NamedSharding``):
:func:`param_shardings` says for every parameter leaf its spec over the
mesh's axes, the dim the ``model`` axis splits (``"dim"``), the dim the
``data`` axis splits (``"data_dim"``, FSDP) and the per-rank shape (what
``lm.shard_params`` cuts); :func:`opt_state_shardings` the same for
AdamW's ``m`` and ``v``; :func:`batch_sharding` splits dim 0 over
``("pod", "data")`` where it divides (else replicates it, JAX's
fallback). :func:`decode_state_shardings` is the decode state's (the
KV caches' batch on ``("pod", "data")`` and sequence on ``model``, the
recurrent state's batch on ``("pod", "data")``), and
:func:`jitted_serve_step` is JAX's serve step on those shardings, on
any mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding_rules as sr
from repro_torch.models import lm
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw


# ------------------------------------------------------------- input specs
def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> dict:
    """Meta-tensor stand-ins for every model input of this cell, JAX's
    shapes and dtypes: train/prefill {"tokens", "labels"} (B, S) int32,
    plus "patches" (B, P, frontend_dim) bf16 for the vlm, "frames" (B, S,
    frontend_dim) bf16 in place of "tokens" for audio; decode one new
    token (B, 1) against a cache of ``seq_len`` ("state")."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": _spec((B, S, cfg.frontend_dim),
                                    torch.bfloat16),
                    "labels": _spec((B, S), i32)}
        out = {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
        if cfg.family == "vlm":
            out["patches"] = _spec((B, cfg.num_prefix_tokens,
                                    cfg.frontend_dim), torch.bfloat16)
        return out
    return {"token": _spec((B, 1), i32),
            "state": decode_state_specs(cfg, B, S)}


def decode_state_specs(cfg, batch: int, max_len: int) -> dict:
    """The contiguous decode state at one rank ({"caches", "cur_len"}, as
    ``lm.init_decode_state`` makes it), as meta tensors."""
    from repro_torch.models import transformer
    return {"caches": transformer.init_caches(cfg, batch, max_len,
                                              cfg.dtype, device="meta"),
            "cur_len": _spec((batch,), torch.int32)}


def param_specs(cfg, trainable: bool = True) -> dict:
    """The parameter tree as meta tensors of the dtypes the port stores:
    fp32 masters (``trainable``, JAX's ``param_dtype``) or the serving
    storage (``lm.storage_dtype``)."""
    from repro_torch.models.module import tree_map
    return tree_map(lambda path, p: _spec(
        p.shape, cfg.param_dtype if trainable
        else lm.storage_dtype(path, cfg)), lm.lm_spec(cfg))


# ----------------------------------------------------------- sharding trees
def _placed(shape, spec, mesh_shape) -> dict:
    return {"dim": sr.dim_of(spec, "model"),
            "data_dim": sr.dim_of(spec, "data"),
            "spec": tuple(spec),
            "shape": sr.spec_shape(shape, spec, mesh_shape)}


def param_shardings(cfg, rules: sr.Rules) -> dict:
    """JAX's ``param_shardings``: the parameter tree with a leaf
    ``{"spec", "dim", "data_dim", "shape"}`` for every parameter: its
    spec over the mesh's axes, the dims the ``model`` and the ``data``
    axes split (or None) and the per-rank shape, JAX's
    ``NamedSharding.shard_shape`` (``sharding_rules``' divisibility
    fallback replicates, and ``rules.degradations`` records it)."""
    specs = sr.leaf_specs(lm.lm_spec(cfg), rules)
    return tree_map(lambda path, p: _placed(p.shape, specs[path],
                                            rules.shape), lm.lm_spec(cfg))


def opt_state_shardings(cfg, rules: sr.Rules, params_sh) -> dict:
    """JAX's ``opt_state_shardings``: ``m`` and ``v`` placed as the
    parameters, ``step`` replicated."""
    return {"m": params_sh, "v": params_sh,
            "step": _placed((), (), rules.shape)}


def decode_state_shardings(cfg, rules: sr.Rules, state_specs) -> dict:
    """JAX's ``decode_state_shardings``, as :func:`param_shardings`
    leaves over ``state_specs`` (a state, or :func:`decode_state_specs`),
    each leaf's spec from ``sharding_rules.decode_state_spec``: an
    attention KV cache's batch dim on ``("pod", "data")`` and its
    sequence dim on ``model`` (the port's strided layout,
    ``lm.init_decode_state``), the recurrent state's batch on
    ``("pod", "data")``, each where it divides; ``cur_len`` replicated.
    A paged state (one holding ``"block_tables"``) is the port's own
    layout: each KV pool's blocks split over every rank of the mesh
    (``sharding_rules.pool_blocks``, its padding recorded in
    ``rules.degradations``), the block tables replicated; per-rank
    shapes under ``"shape"``."""
    paged = "block_tables" in state_specs
    ranks = 1
    for n in rules.shape.values():
        ranks *= n
    axes = tuple(a for a in ("pod", "data", "model")
                 if rules.shape.get(a, 1) > 1)

    def one(path, x):
        leaf = path.rsplit(".", 1)[-1]
        if paged and leaf in ("k", "v"):
            n_loc, _ = sr.pool_blocks(x.shape[1], ranks, rules)
            spec = (None, axes if len(axes) > 1 else (axes or (None,))[0],
                    *(None,) * (x.dim() - 2))
            return {**_placed(x.shape, spec, rules.shape),
                    "shape": (x.shape[0], n_loc, *x.shape[2:])}
        if paged and leaf == "block_tables":
            return _placed(x.shape, (None,) * x.dim(), rules.shape)
        return _placed(x.shape, sr.decode_state_spec(path, x.shape, rules),
                       rules.shape)
    return tree_map(one, state_specs)


def batch_sharding(rules: sr.Rules, specs) -> dict:
    """JAX's ``batch_sharding``: each leaf's ``sharding_rules.batch_spec``
    (dim 0 over the ``("pod", "data")`` axes where it divides by their
    product, else replicated; ``"data_dim"`` 0 or None, ``"dim"`` None:
    the model axis splits no batch)."""
    return tree_map(lambda _, x: _placed(
        x.shape, sr.batch_spec(x.shape, rules.shape), rules.shape), specs)


def jitted_serve_step(cfg, mesh, fusion_mode: str = "auto"):
    """JAX's ``jitted_serve_step``: (serve_fn, ctx, shardings). ``ctx``
    is the ``DistContext`` of ``mesh`` (None: one rank) and
    ``fusion_mode``; ``shardings`` is :func:`param_shardings`;
    ``serve_fn(params, token, state)`` runs :func:`make_serve_step`'s
    step under ``ctx`` with ``params`` placed as ``shardings`` says
    (``lm.shard_params(params, mesh)``, JAX's ``device_put`` on them)
    and ``state`` from ``lm.init_decode_state`` under ``ctx``. PyTorch
    runs eagerly: nothing is compiled."""
    rules = sr.rules_for(cfg, mesh)
    ctx = dctx.DistContext(mesh if mesh is not None and mesh.size > 1
                           else None, fusion_mode)
    step_fn = make_serve_step(cfg)

    def serve_fn(params, token, state):
        with dctx.use(ctx), torch.no_grad():
            return step_fn(params, token, state)
    return serve_fn, ctx, param_shardings(cfg, rules)


def init_opt_state(params):
    """AdamW state of an LM, or one per rank of a per-rank list."""
    states = [adamw.init_state(lm.param_tree(p))
              for p in lm.as_ranks(params)]
    return states if isinstance(params, list) else states[0]


def _grads(tree):
    return tree_map(lambda _, p: p.grad, tree)


def synthetic_batch(cfg, batch: int, seq: int, seed: int = 0,
                    device="cpu") -> dict:
    """A seeded training batch holding what JAX's ``input_specs`` name
    for ``cfg``'s family (``repro.launch.steps``): "tokens" and "labels"
    (batch, seq) int32, plus "patches" (batch, num_prefix_tokens,
    frontend_dim) for the vlm; "frames" (batch, seq, frontend_dim) and
    "labels" for audio. The features are standard normal float32 (the
    projection casts them to ``cfg.dtype``); tokens and labels are drawn
    uniformly from the vocabulary (numpy's ``default_rng(seed)``)."""
    r = np.random.default_rng(seed)

    def ids():
        return r.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)

    def feats(n):
        return r.standard_normal((batch, n, cfg.frontend_dim),
                                 dtype=np.float32)
    if cfg.family == "audio":
        out = {"frames": feats(seq), "labels": ids()}
    else:
        out = {"tokens": ids(), "labels": ids()}
        if cfg.family == "vlm":
            out["patches"] = feats(cfg.num_prefix_tokens)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    def train_step(params, opt_state, batch):
        """params: a trainable :class:`~repro_torch.models.lm.LM`, or a
        list of per-rank ones over the ambient mesh; opt_state:
        :func:`init_opt_state` of them; batch: {"tokens", "labels"} (B,
        S), with "patches" for a vlm, "frames" in place of "tokens" for
        audio (:func:`synthetic_batch`), placed by
        ``data.pipeline.shard_batch`` (over data groups one batch a
        group, ``lm.loss_fn``). Leaves this step's
        gradients on the parameters (``.grad``; the ranks that hold the
        same block of a leaf hold the sum over them)."""
        ranks = lm.as_ranks(params)
        for p in ranks:
            p.zero_grad(set_to_none=True)
        loss, metrics = lm.loss_fn(params, batch, cfg)
        loss.backward()
        trees = [lm.param_tree(p) for p in ranks]
        mesh = dctx.current().mesh
        om = adamw.apply_updates_ranks(
            trees, [_grads(t) for t in trees], lm.as_ranks(opt_state),
            opt_cfg, {} if mesh is None else lm.leaf_specs(cfg, mesh),
            {"model": 1} if mesh is None else mesh.shape, mesh)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        """The full-sequence forward (prefill) and loss, no gradients;
        ``params`` as the train step takes them."""
        loss, metrics = lm.loss_fn(params, batch, cfg)
        return {"loss": loss, **metrics}
    return eval_step


def make_serve_step(cfg):
    def serve_step(params, token, state):
        return lm.decode_step(params, token, state, cfg)
    return serve_step
