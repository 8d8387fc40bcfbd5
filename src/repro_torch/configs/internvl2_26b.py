"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d_model=6144 48H
(GQA kv=8) d_ff=16384, vocab=92553; InternViT frontend.
[arXiv:2404.16821; hf]

The vision frontend is a STUB: input_specs() provides precomputed
patch embeddings (B, n_patches, 6144) prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, frontend="vision", n_frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, frontend="vision", n_frontend_tokens=8,
    dtype="float32",
)
