"""Assigned architecture config (see assignment table in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

# [vlm] 18L d=2048 8H (kv=1) ff=16384 v=257216 — SigLIP stub + gemma decoder
CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab_size=257216, head_dim=256,
    block="attn_mlp", act="geglu", rope_theta=10000.0,
    num_prefix_tokens=256, frontend_dim=1152, prefix_lm=True,
    tie_embeddings=True,
    # tied embeddings: the (in_vocab->data, in_embed->model) input layout
    # conflicts with the logits use of the same table (measured +38% wire,
    # EXPERIMENTS §Perf B3) -> keep the head-style layout for the table
    sharding_overrides=(("in_vocab", ("model",)), ("in_embed", ("data",))))
PALIGEMMA_3B = CONFIG
