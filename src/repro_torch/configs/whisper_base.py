"""whisper-base [audio enc-dec] — 6L enc + 6L dec, d_model=512, 8H,
d_ff=2048, vocab=51865.  [arXiv:2212.04356]

The conv audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, n_frames, 512).  Backbone deviations noted in
DESIGN.md: RoPE replaces learned/sinusoidal absolute positions,
RMSNorm replaces LayerNorm (pre-norm structure preserved).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, frontend="audio",
    n_frontend_tokens=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, frontend="audio", n_frontend_tokens=30,
    dtype="float32",
)
