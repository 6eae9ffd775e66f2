"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066].  First layer dense (d_ff 10944) per the paper."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=10944, vocab_size=102400,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, capacity_factor=1.25,
    rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    num_experts=8, num_shared_experts=2, top_k=2, moe_d_ff=64,
    first_dense_layers=1,
    param_dtype="float32", compute_dtype="float32", attn_kv_block=64,
)
