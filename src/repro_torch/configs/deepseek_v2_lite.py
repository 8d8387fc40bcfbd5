"""deepseek-v2-lite [moe, MLA] — 27L d_model=2048 16H, vocab=102400,
untied; MLA with no q LoRA under YaRN; layer 0 a dense SwiGLU of
10944, layers 1-26 MoE: 64 routed experts of 1408, top-6, softmax gates
not renormalised, 2 shared experts, every token routed (no capacity).
15.7 B parameters.  [hf:deepseek-ai/DeepSeek-V2-Lite config.json;
arXiv:2405.04434]

Read as the port's fields: ``head_dim`` is qk_nope_head_dim and
v_head_dim (both 128), ``rope_head_dim`` qk_rope_head_dim, ``d_ff`` the
experts' width (moe_intermediate_size) and ``dense_d_ff`` the dense
layer's (intermediate_size); the 2 shared experts are one SwiGLU of
2 x 1408.  rope_scaling: YaRN, factor 40 over 4096 positions, beta_fast
32, beta_slow 1, mscale = mscale_all_dim = 0.707.  The training aux loss
(seq_aux, alpha 0.001) is left out (``router_aux_loss`` 0): no cell
trains this model.  Not an assigned architecture: not in ``ARCHS``.
"""
from repro_torch.models.config import ExtendedConfig

CONFIG = ExtendedConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, head_dim=128,
    n_experts=64, experts_per_token=6, router_aux_loss=0.0,
    use_mla=True, q_lora_rank=0, kv_lora_rank=512, rope_head_dim=64,
    first_dense_layers=1, dense_d_ff=10944, n_shared_experts=2,
    moe_renorm=False, moe_dropless=True,
    rope_factor=40.0, rope_original_len=4096, rope_beta_fast=32.0,
    rope_beta_slow=1.0, rope_mscale=0.707, rope_mscale_all_dim=0.707,
)

SMOKE = ExtendedConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=16,
    vocab_size=256, head_dim=16,
    n_experts=8, experts_per_token=3, router_aux_loss=0.0,
    use_mla=True, q_lora_rank=0, kv_lora_rank=32, rope_head_dim=8,
    first_dense_layers=1, dense_d_ff=96, n_shared_experts=1,
    moe_renorm=False, moe_dropless=True,
    rope_factor=4.0, rope_original_len=64, rope_beta_fast=32.0,
    rope_beta_slow=1.0, rope_mscale=0.707, rope_mscale_all_dim=0.707,
    dtype="float32",
)
