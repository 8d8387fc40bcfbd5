"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]

Sub-quadratic: the long_500k shape RUNS for this arch.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=128, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_groups=1, ssm_chunk=16, tie_embeddings=True, dtype="float32",
)
