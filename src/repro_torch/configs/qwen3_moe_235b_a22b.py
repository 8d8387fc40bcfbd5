"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
d_ff=1536/expert, vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B family; hf]

EP: 128 experts % 16 model shards == 0 -> true expert parallelism.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, n_experts=128, experts_per_token=8,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=48,
    vocab_size=256, n_experts=8, experts_per_token=2, dtype="float32",
)
