"""Token samplers (port of ``repro.serving.sampler``): greedy only.

The seeded temperature/top-k batch sampler needs JAX's threefry
``fold_in`` + ``categorical`` reproduced bit-exactly to keep streams
token-identical to the JAX engine; it belongs to a later slice.
"""
from __future__ import annotations

import torch


def greedy(logits):
    """logits: (B, 1, V) -> (B, 1) int32 (first index on ties)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
