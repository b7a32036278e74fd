"""Model configuration schema (PyTorch port of ``repro.configs.base``).

One :class:`ModelConfig` describes any of the 10 assigned architectures.
The fields are the JAX package's, with ``dtype``/``param_dtype`` held as
torch dtypes. The port's model code implements every block
(``attn_mlp``, ``attn_moe``, ``mamba_hybrid``, ``rwkv``; see
``models/transformer.py``) and the vlm and audio frontends (the patch
or frame projection ``frontend_proj``, ``models/lm.py``); an encoder
(``causal=False``: hubert) has no decode step (:attr:`has_decode`).
:class:`ShapeConfig` and the four shapes name the dry run's cells
(``configs.shapes``, ``launch.dryrun``).
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
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(self.n_kv_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.block == "rwkv"

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode step."""
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?

        True for SSM/hybrid (state-space decode) and sliding-window
        attention (cache bounded by the window).
        """
        return (self.block in ("mamba_hybrid", "rwkv")
                or self.sliding_window is not None)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived sizes used by the roofline and memory planning (the
    # JAX package's formulas, kept equal by tests/test_torch_roofline.py)
    def n_params(self) -> int:
        """Analytical parameter count (excludes tiny norm params)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.block == "rwkv":
            # time-mix: r,k,v,g,o (d*d) + w lora + ffn (2 * d * f)
            per_layer = 5 * d * d + 2 * d * f + d * 2 * self.hd_rwkv()
        elif self.block == "mamba_hybrid":
            d_in = self.ssm_expand * d
            per_mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            attn_params = (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                           + self.n_heads * hd * d + 3 * d * f)
            return emb + self.n_layers * per_mamba + attn_params
        else:
            attn = (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                    + self.n_heads * hd * d)
            if self.block == "attn_moe":
                mlp = (self.moe_num_experts * 3 * d * f
                       + d * self.moe_num_experts)
            else:
                glu = 3 if self.act in ("swiglu", "geglu") else 2
                mlp = glu * d * f
            per_layer = attn + mlp
        return emb + self.n_layers * per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE counts only routed experts)."""
        if self.block != "attn_moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        hd = self.hd
        attn = (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                + self.n_heads * hd * d)
        mlp = self.moe_top_k * 3 * d * f + d * self.moe_num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + mlp)

    def hd_rwkv(self) -> int:
        return 64  # rwkv6 head size


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell's input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
