"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [moe] 56L d=6144 48H (kv=8) ff=16384/expert v=32768, 8e top-2, SWA
CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=32768, head_dim=128,
    block="attn_moe", act="swiglu", rope_theta=1e6,
    moe_num_experts=8, moe_top_k=2, sliding_window=4096,
    # E=8 < model=16 would degrade expert sharding to full replication
    # (4.8 GB of expert weights all-gathered per layer); instead TP-shard
    # each expert's d_ff over `model` (hillclimbed: EXPERIMENTS.md §Perf)
    sharding_overrides=(("experts", ()), ("expert_mlp", ("model",))))
MIXTRAL_8X22B = CONFIG
