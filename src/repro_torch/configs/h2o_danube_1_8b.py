"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, sliding_window=4096, rope_theta=10000.0,
)

SMOKE = CONFIG.replace(name="h2o-danube-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                       sliding_window=32)
