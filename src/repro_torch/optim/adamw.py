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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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
    ``state["step"]``; ``grads`` is keyed like ``params``. Returns the
    metrics {"grad_norm", "lr"} (float32 0-d tensors)."""
    p_items = list(tree_items(params))
    g_l = dict(tree_items(grads))
    m_l = dict(tree_items(state["m"]))
    v_l = dict(tree_items(state["v"]))
    state["step"] += 1
    step = state["step"]
    gnorm = global_norm(grads)
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
