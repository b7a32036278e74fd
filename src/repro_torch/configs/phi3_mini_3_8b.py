"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [dense] 32L d=3072 32H (kv=32) ff=8192 v=32064 — RoPE SwiGLU
CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064,
    block="attn_mlp", act="swiglu", rope_theta=10000.0)
PHI3_MINI_3_8B = CONFIG
