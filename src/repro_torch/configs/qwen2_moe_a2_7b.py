"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.
24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, n_shared_experts=4, top_k=4, moe_d_ff=1408,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(name="qwen2-moe-smoke", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                       n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=128,
                       capacity_factor=8.0)   # dropless in smoke tests
