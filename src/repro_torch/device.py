"""Device selection shared by the port's entry points.

The entry points (``models.lm.init_params``, ``serving.engine.Engine``,
``launch.serve``) run on the card unless the caller asks for the CPU:
``device="cuda"`` is the default, and without a visible GPU it raises
instead of quietly continuing on the CPU. ``device="cpu"`` runs the
kernels' plain PyTorch versions (what the tests do).

This module holds the port's one CUDA availability probe (the lint's
KRN001 flags one anywhere else in ``kernels/`` and ``core/``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected "
                         f"'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "versions on the CPU")
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False on a
    build or a machine without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
