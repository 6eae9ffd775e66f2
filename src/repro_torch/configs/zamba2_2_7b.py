"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  The reference's simplifications of the released model
hold here too: the shared block consumes the hidden state directly (no
concat-with-embedding projection, no per-invocation LoRA)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_conv=4, ssm_chunk=128,
    shared_attn_every=6, rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_chunk=16, shared_attn_every=2,
    param_dtype="float32", compute_dtype="float32", attn_kv_block=64,
)
