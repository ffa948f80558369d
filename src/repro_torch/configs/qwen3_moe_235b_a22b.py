"""qwen3-moe-235b-a22b [moe]: 128 routed experts, top-8, no shared experts.
94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936,
    n_experts=128, n_shared_experts=0, top_k=8, moe_d_ff=1536,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(name="qwen3-moe-smoke", n_layers=3, d_model=128,
                       n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
                       n_experts=16, top_k=4, moe_d_ff=128,
                       capacity_factor=8.0)   # dropless in smoke tests
