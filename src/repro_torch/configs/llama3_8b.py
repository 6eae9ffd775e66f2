"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=128256,
    rope_theta=500000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, param_dtype="float32", compute_dtype="float32",
    attn_kv_block=64,
)
