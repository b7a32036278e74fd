"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [hybrid] 38L d=2048 32H (kv=32) ff=8192 v=32000 ssm_state=64 — Mamba2+shared attn
CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    block="mamba_hybrid", act="swiglu", rope_theta=10000.0,
    ssm_state=64, ssm_expand=2, ssm_conv_width=4, attn_every=6)
ZAMBA2_1_2B = CONFIG
