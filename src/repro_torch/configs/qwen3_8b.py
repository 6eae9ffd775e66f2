"""qwen3-8b [dense] — GQA with qk-norm [hf:Qwen/Qwen3-8B]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, param_dtype="float32", compute_dtype="float32",
    attn_kv_block=64,
)
