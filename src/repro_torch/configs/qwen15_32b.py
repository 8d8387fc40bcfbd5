"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40 == MHA)
d_ff=27392, vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5 family; hf]

TP note: 40 heads over the 16-way model axis shard unevenly (GSPMD
pads 40->48); documented in the roofline table.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen15-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, qkv_bias=True, dtype="float32",
)
