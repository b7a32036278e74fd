"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [dense] 32L d=4096 32H (kv=8) ff=14336 v=128256
CONFIG = ModelConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    block="attn_mlp", act="swiglu", rope_theta=500000.0)
LLAMA3_8B = CONFIG
