"""mistral-nemo-12b [dense] — GQA, 128k ctx, head_dim 128
[hf:mistralai/Mistral-Nemo-Base-2407]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=160, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=320, vocab_size=512, param_dtype="float32", compute_dtype="float32",
    attn_kv_block=64,
)
