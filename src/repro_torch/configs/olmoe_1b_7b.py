"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [moe] 16L d=2048 16H (kv=16) ff=1024/expert v=50304, 64e top-8
CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
    block="attn_moe", act="swiglu", rope_theta=10000.0,
    moe_num_experts=64, moe_top_k=8)
OLMOE_1B_7B = CONFIG
