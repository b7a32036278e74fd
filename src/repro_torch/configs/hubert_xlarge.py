"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [audio] 48L d=1280 16H (kv=16) ff=5120 v=504 — encoder-only
CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
    block="attn_mlp", act="gelu", norm="layernorm", causal=False,
    rope_theta=0.0, frontend_dim=512)
HUBERT_XLARGE = CONFIG
