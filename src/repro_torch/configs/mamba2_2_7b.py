"""mamba2-2.7b [ssm] — SSD, attention-free [arXiv:2405.21060]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    head_dim=0, d_ff=0, vocab_size=50280,
    attention="none",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_conv=4, ssm_chunk=128,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    param_dtype="float32", compute_dtype="float32",
)
