"""musicgen-large [audio]: decoder-only over EnCodec tokens (stub frontend).
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, frontend="audio", mlp_act="gelu",
)

SMOKE = CONFIG.replace(name="musicgen-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=4, d_ff=256, vocab=256)
