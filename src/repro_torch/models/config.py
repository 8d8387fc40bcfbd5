"""Model / run configuration dataclasses (a copy of ``repro.models.config``).

One :class:`ModelConfig` per assigned architecture lives in
``repro_torch/configs/<id>.py``; :class:`ShapeConfig` describes the four
assigned input shapes.  The fields are the reference's, unchanged, so a
config means the same model in both packages; the port serves every
family (:mod:`repro_torch.models.model`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # --- MLA (minicpm3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 32            # decoupled RoPE dims for MLA

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    conv_width: int = 4

    # --- hybrid (zamba2): shared attention block every k layers ---
    attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str | None = None        # "audio" | "vision"
    n_frontend_tokens: int = 0         # frames / patches provided by stub

    # --- misc architecture ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- runtime knobs (not architecture) ---
    dtype: str = "bfloat16"
    remat: str = "dots"                # "none" | "dots" | "full"
    attn_impl: str = "auto"            # ops.py impl selector
    attn_chunk: int = 0                # 0 = unchunked reference attention
    attn_unroll: bool = False          # unroll the KV-chunk scan (calibration)
    microbatches: int = 1              # gradient-accumulation factor
    scan_layers: bool = True
    # --- perf knobs (EXPERIMENTS.md §Perf) ---
    kv_repeat_to: int = 0              # replicate KV heads up to the TP
                                       # width so the cache arg shards
                                       # evenly (kills decode gathers)
    moe_groups: int = 0                # dispatch groups (0 = per batch
                                       # row; 1 = one global group —
                                       # right for decode)
    mla_absorb: str = "decode"         # "decode" | "always": absorbed
                                       # MLA only where it wins

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run the long_500k shape? (assignment rule)"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_attn = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
        if self.use_mla:
            r, kr = self.kv_lora_rank, self.rope_head_dim
            qr = self.q_lora_rank or d
            per_attn = (d * qr + qr * Hq * (hd + kr)      # q down/up
                        + d * (r + kr)                     # kv down + rope k
                        + r * Hq * 2 * hd                  # kv up (k_nope, v)
                        + Hq * hd * d)                     # o
        per_mlp = 3 * d * ff
        if self.n_experts:
            per_mlp = per_mlp * self.n_experts + d * self.n_experts
        per_norms = 2 * d
        per_layer = per_attn + per_mlp + per_norms
        if self.family in ("ssm", "hybrid"):
            di, n, g = self.d_inner, self.ssm_state, self.ssm_groups
            H = self.ssm_heads
            per_mamba = (d * (2 * di + 2 * g * n + H)      # in_proj
                         + self.conv_width * (di + 2 * g * n)
                         + di * d + di + 2 * H + d)        # out_proj, norms, A, D
            if self.family == "ssm":
                per_layer = per_mamba
            else:
                shared_attn = per_attn + per_mlp + per_norms
                n_sites = L // self.attn_every if self.attn_every else 0
                return emb + L * per_mamba + shared_attn + d + n_sites * 0
        total = emb + L * per_layer + d
        if self.n_enc_layers:
            total += self.n_enc_layers * per_layer
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameter count — differs for MoE."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense_mlp = 3 * d * ff
        moe_mlp = dense_mlp * self.n_experts
        active_mlp = dense_mlp * self.experts_per_token
        return self.n_params() - self.n_layers * (moe_mlp - active_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
