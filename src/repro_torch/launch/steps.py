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
storage), which ``launch.dryrun`` makes fake tensors of; the JAX
module's sharding trees belong to its data x model meshes, which the
port does not build.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import context as dctx
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
        audio (:func:`synthetic_batch`), the whole batch (every rank
        reads it; data axis 1). Leaves
        this step's gradients on the parameters (``.grad``; a replicated
        leaf's copies hold the sum over the ranks)."""
        ranks = lm.as_ranks(params)
        for p in ranks:
            p.zero_grad(set_to_none=True)
        loss, metrics = lm.loss_fn(params, batch, cfg)
        loss.backward()
        trees = [lm.param_tree(p) for p in ranks]
        mesh = dctx.current().mesh
        om = adamw.apply_updates_ranks(
            trees, [_grads(t) for t in trees], lm.as_ranks(opt_state),
            opt_cfg, {} if mesh is None else lm.shard_dims(cfg, mesh))
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
