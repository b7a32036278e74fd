"""Model configuration schema (PyTorch port of ``repro.configs.base``).

One :class:`ModelConfig` describes any of the 10 assigned architectures.
The fields are the JAX package's, with ``dtype``/``param_dtype`` held as
torch dtypes. The port's model code implements every block
(``attn_mlp``, ``attn_moe``, ``mamba_hybrid``, ``rwkv``; see
``models/transformer.py``); the vlm and audio frontends raise
``NotImplementedError`` where the model is built (``models/lm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # block behaviour
    block: str = "attn_mlp"           # attn_mlp | attn_moe | mamba_hybrid | rwkv
    act: str = "swiglu"               # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    causal: bool = True               # False -> encoder (hubert)
    rope_theta: float = 10000.0
    sliding_window: int | None = None # SWA width (mixtral)
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0

    # modality frontend stubs
    num_prefix_tokens: int = 0
    frontend_dim: int = 0
    prefix_lm: bool = False

    # numerics
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master params

    # runtime behaviour (prefill/train knobs, kept for field parity)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    fusion_mode: str = "auto"
    sharding_overrides: tuple = ()

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode step."""
        return self.causal

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
