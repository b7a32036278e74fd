"""Parameter conversion from the JAX package's tree.

The JAX side hands over its parameter pytree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``); this module only sees
numpy, never JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import LM, from_tree


def params_from_numpy(tree: dict, cfg, device="cuda",
                      trainable: bool = False) -> LM:
    """The port's :class:`~repro_torch.models.lm.LM` for a JAX parameter
    tree, key for key and shape for shape (stacked ``(n_layers, ...)``
    layer leaves kept as they are), each leaf in its storage dtype, or
    as fp32 masters that require grad (``trainable``)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, dtype=np.float32)).to(dev)
    return from_tree(cfg, conv(tree), trainable)
