"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [ssm] 32L d=2560 (attn-free) ff=8960 v=65536 — Finch data-dependent decay
CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab_size=65536,
    block="rwkv", act="relu2", norm="layernorm", rope_theta=0.0)
RWKV6_3B = CONFIG
