"""internvl2-76b [vlm]: InternViT (stub frontend) + LLM backbone.
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, frontend="vision", rope_theta=500000.0,
)

SMOKE = CONFIG.replace(name="internvl2-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=2, d_ff=256, vocab=512)
