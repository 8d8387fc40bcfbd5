"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576,
vocab=49152, llama-arch code model.  [arXiv:2405.04324; hf]

MQA: the single KV head is replicated across the model axis; KV-cache
per token is 48x smaller than MHA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152,
)

SMOKE = ModelConfig(
    name="granite20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, dtype="float32",
)
