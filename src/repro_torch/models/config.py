"""Model / run configuration dataclasses (a copy of ``repro.models.config``).

One :class:`ModelConfig` per assigned architecture lives in
``repro_torch/configs/<id>.py``; :class:`ShapeConfig` describes the four
assigned input shapes.  The fields are the reference's, unchanged, so a
config means the same model in both packages; the port serves every
family (:mod:`repro_torch.models.model`).

:class:`ExtendedConfig` adds the architecture that the reference has no
field for (DeepSeek-V2's leading dense layers, shared experts, routing
without renormalisation or capacity, YaRN).  Its fields are plain class
attributes of :class:`ModelConfig` at today's behaviour, so every
:class:`ModelConfig` reads them, and ``dataclasses.asdict`` of one is
still the reference's.
"""
from __future__ import annotations

import dataclasses
import math
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

    # --- architecture the reference has no field for: ExtendedConfig's
    # fields, class attributes here at their defaults (set below) ---

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
            qr = self.q_lora_rank
            q = (d * qr + qr * Hq * (hd + kr) if qr       # q down/up
                 else d * Hq * (hd + kr))                  # or direct
            per_attn = (q
                        + d * (r + kr)                     # kv down + rope k
                        + r * Hq * 2 * hd                  # kv up (k_nope, v)
                        + Hq * hd * d)                     # o
        per_mlp = 3 * d * ff
        if self.n_experts:
            per_mlp = (per_mlp * (self.n_experts + self.n_shared_experts)
                       + d * self.n_experts)
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
        k = self.first_dense_layers    # leading layers with a dense MLP
        dense = per_attn + 3 * d * (self.dense_d_ff or ff) + per_norms
        total = emb + (L - k) * per_layer + k * dense + d
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
        return self.n_params() - (self.n_layers - self.first_dense_layers
                                  ) * (moe_mlp - active_mlp)

    @property
    def yarn_mscale(self) -> float:
        """YaRN's factor on the softmax scale (its mscale twice, at
        ``rope_mscale_all_dim``); 1 without YaRN."""
        return yarn_m(self.rope_factor, self.rope_mscale_all_dim) ** 2 \
            if self.rope_mscale_all_dim else 1.0


def yarn_m(factor: float, m: float) -> float:
    """YaRN's ``get_mscale``: 0.1 m ln(factor) + 1 above factor 1."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


@dataclasses.dataclass(frozen=True)
class ExtendedConfig(ModelConfig):
    """A :class:`ModelConfig` with the architecture the reference has no
    field for, as fields (their defaults are today's behaviour).

    ``first_dense_layers`` leading layers take a dense SwiGLU of width
    ``dense_d_ff``; the rest are MoE layers, each with
    ``n_shared_experts`` shared experts of width ``d_ff`` on the same
    normed input, added.  ``moe_renorm`` False keeps the top-k softmax
    gates as they are; ``moe_dropless`` routes every choice, with no
    capacity and no dropped token.  ``rope_factor`` > 1 turns on YaRN for
    MLA's rope dims (DeepSeek-V2's ``rope_scaling``: factor, original
    length, beta_fast, beta_slow, mscale, mscale_all_dim)."""
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    n_shared_experts: int = 0
    moe_renorm: bool = True
    moe_dropless: bool = False
    rope_factor: float = 0.0
    rope_original_len: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0

    def __post_init__(self):
        # the capacity route runs no shared experts and renormalises
        if not self.moe_dropless and (self.n_shared_experts
                                      or not self.moe_renorm):
            raise ValueError(
                f"{self.name}: shared experts, and top-k gates that are not "
                "renormalised, run only on the dropless route "
                "(moe_dropless=True)")


# every ModelConfig reads ExtendedConfig's defaults, today's behaviour, as
# class attributes and not fields, so its asdict is still the reference's
for _f in dataclasses.fields(ExtendedConfig):
    if _f.name not in ModelConfig.__dataclass_fields__:
        setattr(ModelConfig, _f.name, _f.default)
del _f


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
