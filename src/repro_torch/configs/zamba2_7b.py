"""zamba2-7b [hybrid]: Mamba2 backbone + one shared attention(+MLP) block
applied every 6 layers.  81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64 [arXiv:2411.15242; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, attn_every=6,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(name="zamba2-smoke", n_layers=5, d_model=128,
                       n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
                       ssm_state=16, attn_every=2, ssm_heads=4)
