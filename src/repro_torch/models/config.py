"""Model configuration (the port's own copy of ``repro.models.config``),
field for field the JAX ``ModelConfig``."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..kernels.registry import KernelPolicy


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention flavour
    attention: str = "gqa"         # gqa | mla | none (ssm)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500000.0
    m_rope: bool = False           # 3-section rope (qwen2-vl)
    m_rope_sections: tuple[int, int, int] = (16, 24, 24)

    # MLA (deepseek-v3) dims
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # deepseek: leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0

    # io / embedding
    embed_input: bool = True       # False: stub frontend supplies embeddings
    tie_embeddings: bool = False
    act: str = "silu"              # silu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    q8_cache: bool = False         # int8 KV cache (fixed-point serving)
    kv_cache_delta: float = 1.0 / 16.0   # int8 KV grid step

    # kernel selection: one policy for every registered op (platform
    # dispatch, per-op impl pins, tile pins, tuning cache) — see
    # repro_torch.kernels.registry
    kernels: KernelPolicy = KernelPolicy()

    # distribution / performance knobs (kept for parity with the reference)
    remat: str = "block"           # none | block | dots
    scan_layers: bool = True
    attn_kv_block: int = 1024
    moe_impl: str = "scatter"      # scatter | dense

    @property
    def d_inner(self) -> int:      # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
