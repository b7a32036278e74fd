"""Registry of the 10 assigned architectures + reduced smoke variants
(PyTorch port of ``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mistral_large_123b import MISTRAL_LARGE_123B
from repro_torch.configs.phi3_mini_3_8b import PHI3_MINI_3_8B
from repro_torch.configs.glm4_9b import GLM4_9B
from repro_torch.configs.llama3_8b import LLAMA3_8B
from repro_torch.configs.paligemma_3b import PALIGEMMA_3B
from repro_torch.configs.olmoe_1b_7b import OLMOE_1B_7B
from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B
from repro_torch.configs.hubert_xlarge import HUBERT_XLARGE
from repro_torch.configs.zamba2_1_2b import ZAMBA2_1_2B
from repro_torch.configs.rwkv6_3b import RWKV6_3B

REGISTRY = {c.name: c for c in (
    MISTRAL_LARGE_123B, PHI3_MINI_3_8B, GLM4_9B, LLAMA3_8B, PALIGEMMA_3B,
    OLMOE_1B_7B, MIXTRAL_8X22B, HUBERT_XLARGE, ZAMBA2_1_2B, RWKV6_3B)}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (same rule as the
    JAX package, so both packages build identical smoke models)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4 if cfg.block != "mamba_hybrid" else 5),
        d_model=128, d_ff=256, vocab_size=512,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        head_dim=32, remat=False,
        attn_chunk_q=32, attn_chunk_kv=32,
    )
    if cfg.block == "attn_moe":
        kw.update(moe_num_experts=8, moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.block == "mamba_hybrid":
        kw.update(ssm_state=16, attn_every=2)
    if cfg.num_prefix_tokens:
        kw.update(num_prefix_tokens=8, frontend_dim=16)
    if cfg.frontend_dim and not cfg.num_prefix_tokens:
        kw.update(frontend_dim=16)
    if cfg.block == "rwkv":
        kw.update(d_model=128, n_heads=2, n_kv_heads=2)
    return cfg.replace(**kw)
