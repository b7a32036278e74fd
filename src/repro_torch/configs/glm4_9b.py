"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [dense] 40L d=4096 32H (kv=2) ff=13696 v=151552
CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151552,
    block="attn_mlp", act="swiglu", rope_theta=10000.0)
GLM4_9B = CONFIG
