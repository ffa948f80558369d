"""rwkv6-3b "Finch" [ssm/attention-free]: data-dependent per-channel decay.
32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, ssm_heads=40,
)

SMOKE = CONFIG.replace(name="rwkv6-smoke", n_layers=2, d_model=128,
                       n_heads=2, n_kv_heads=2, d_ff=256, vocab=512,
                       ssm_heads=2)
