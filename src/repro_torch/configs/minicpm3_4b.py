"""minicpm3-4b [dense, MLA] — 62L d_model=2560 40H d_ff=6400,
vocab=73448, Multi-head Latent Attention.  [hf:openbmb/MiniCPM3-4B; hf]

MLA ranks from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64 (head_dim), qk_rope_head_dim=32.  The cache stores
(256+32) floats/token instead of 2*40*64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73448, head_dim=64,
    use_mla=True, q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
    dtype="float32",
)
