"""granite-8b [dense]: llama-architecture code model.
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 [arXiv:2405.04324; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, rope_theta=10000000.0,
)

SMOKE = CONFIG.replace(name="granite-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=2, d_ff=256, vocab=512)
