"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437].  MTP head omitted (orthogonal to weight coding).
First 3 layers dense (d_ff 18432) per the paper."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129280,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, capacity_factor=1.25,
    rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    q_lora_rank=48, kv_lora_rank=32,
    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=64,
    first_dense_layers=1,
    param_dtype="float32", compute_dtype="float32", attn_kv_block=64,
)
