"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# --------------------------------------------------------------------------
# [dense] 88L d=12288 96H (kv=8) ff=28672 v=32768
CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab_size=32768, head_dim=128,
    block="attn_mlp", act="swiglu", rope_theta=1e6)
MISTRAL_LARGE_123B = CONFIG
