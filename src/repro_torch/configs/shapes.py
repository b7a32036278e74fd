"""The (architecture x input-shape) grid and its applicability (port of
``repro.configs.shapes``)."""
from __future__ import annotations

from repro_torch.configs.base import ALL_SHAPES, ShapeConfig

ARCH_IDS = (
    "mistral-large-123b", "phi3-mini-3.8b", "glm4-9b", "llama3-8b",
    "paligemma-3b", "olmoe-1b-7b", "mixtral-8x22b", "hubert-xlarge",
    "zamba2-1.2b", "rwkv6-3b",
)


def applicable(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-not)."""
    if shape.is_decode and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention: 500k decode needs sub-quadratic"
    return True, ""


def cells(arch_ids=ARCH_IDS, shapes=ALL_SHAPES):
    """Yield every nominal cell with its applicability."""
    from repro_torch.configs import get_config
    for a in arch_ids:
        cfg = get_config(a)
        for s in shapes:
            ok, why = applicable(cfg, s)
            yield a, s, ok, why
