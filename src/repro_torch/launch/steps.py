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
(:func:`synthetic_batch`). The JAX module's sharding trees belong to its
dry run and have no counterpart yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import context as dctx
from repro_torch.models import lm
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw


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
