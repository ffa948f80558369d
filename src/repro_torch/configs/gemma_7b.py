"""gemma-7b [dense]: GeGLU activation, head_dim=256 (> d_model/n_heads),
tied embeddings.  28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab=256000, mlp_act="gelu",
    tie_embeddings=True, rope_theta=10000.0,
)

SMOKE = CONFIG.replace(name="gemma-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256, vocab=512)
