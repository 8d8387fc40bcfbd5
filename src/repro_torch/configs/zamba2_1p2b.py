"""zamba2-1.2b [hybrid] — 38 Mamba2 layers d_model=2048 + shared
attention block (32H, kv=32, d_ff=8192) applied every 6 layers,
vocab=32000, ssm_state=64.  [arXiv:2411.15242; hf]

Sub-quadratic overall: long_500k RUNS (the 6 shared-attention sites
hold the only KV caches).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=128, attn_every=6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_groups=1, ssm_chunk=16, attn_every=2, tie_embeddings=True,
    dtype="float32",
)
