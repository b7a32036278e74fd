"""Train / eval / serve step functions at W = 1 (port of
``repro.launch.steps``).

PyTorch runs eagerly, so a step is a plain function: the train step
runs the forward and the loss, the backward (every projection's
gradient through the GEMM kernel), and the AdamW update IN PLACE on the
parameters and the optimizer state, which it returns for the caller's
convenience. The JAX module's sharding trees and ``input_specs`` belong
to its dry run and have no counterpart yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    def train_step(params, opt_state, batch):
        """params: a trainable :class:`~repro_torch.models.lm.LM`;
        opt_state: ``adamw.init_state(lm.param_tree(params))``; batch:
        {"tokens", "labels"} (B, S) on the parameters' device. Leaves
        this step's gradients on the parameters (``.grad``)."""
        params.zero_grad(set_to_none=True)
        loss, metrics = lm.loss_fn(params, batch, cfg)
        loss.backward()
        tree = lm.param_tree(params)
        grads = tree_map(lambda _, p: p.grad if p.grad is not None
                         else torch.zeros_like(p), tree)
        om = adamw.apply_updates(tree, grads, opt_state, opt_cfg)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        """The full-sequence forward (prefill) and loss, no gradients."""
        loss, metrics = lm.loss_fn(params, batch, cfg)
        return {"loss": loss, **metrics}
    return eval_step


def make_serve_step(cfg):
    def serve_step(params, token, state):
        return lm.decode_step(params, token, state, cfg)
    return serve_step
