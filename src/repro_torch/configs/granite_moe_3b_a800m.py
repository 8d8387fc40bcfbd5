"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8)
d_ff=512/expert, vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]

EP note: 40 experts are not divisible by the 16-way model axis; the
sharding rules fall back to tensor-parallel *inside* each expert
(d_ff=512 sharded), experts replicated (see DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, n_experts=40, experts_per_token=8,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=8, experts_per_token=2,
    tie_embeddings=True, dtype="float32", ssm_chunk=16,
)
