"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].
Backbone only: the vision tower is a stub — the caller passes
precomputed patch/text embeddings (B, S, d_model) as ``embeds=`` and 3-D
position ids (3, B, S) as ``pos3d=``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    qkv_bias=True, m_rope=True, m_rope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    embed_input=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, m_rope_sections=(4, 6, 6),
    param_dtype="float32", compute_dtype="float32", attn_kv_block=64,
)
