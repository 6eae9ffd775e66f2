"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  Backbone only: the EnCodec frontend is a stub — the
caller passes precomputed frame embeddings (B, S, d_model) as
``embeds=``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    act="gelu", norm="layernorm", rope_theta=10000.0,
    embed_input=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128, param_dtype="float32",
    compute_dtype="float32", attn_kv_block=64,
)
