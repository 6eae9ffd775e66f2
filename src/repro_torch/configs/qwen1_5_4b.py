"""qwen1.5-4b [dense] — MHA with QKV bias [hf:Qwen/Qwen1.5 family]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    head_dim=128, d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, param_dtype="float32", compute_dtype="float32",
    attn_kv_block=64,
)
