"""Counts of the DeepSeek-V2 family (deepseek-v2-lite): its model FLOPs
and the kernel calls its layers make.

Every layer runs MLA: at a prefill the up-projected form through flash
attention (Dk = hd + kr, Dv = hd, one KV head per query head), at a
decode step the absorbed form through decode attention's latent
instance (one latent head of Dk = r + kr, Dv = r, for all query heads).
The leading dense layers' MLP and every MoE layer's shared experts go
through the fused MLP; the routed experts through ``moe_experts``.  Each
call is ``(bytes, flops, peak)`` (``bench.counts.kernels``); flash's
and the latent decode's byte counts are the family's own, since
``kernels.flash_attention`` and ``kernels.decode_attention`` take one D.
"""
from __future__ import annotations

from bench.counts import kernels as K
from bench.counts import peaks


def _sizes(sz: dict) -> tuple[int, int, int, int]:
    """(heads, nope / v head dim, rope dim, kv rank)."""
    return (sz["n_heads"], sz["head_dim"], sz["rope_head_dim"],
            sz["kv_lora_rank"])


def _esize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def weights_per_token(sz: dict) -> int:
    """Weight elements one token is multiplied by: every layer's
    attention projections, the dense layers' MLP, each MoE layer's
    router, shared experts and the K routed experts it passes, and the
    unembedding."""
    d, ff, V, L = sz["d_model"], sz["d_ff"], sz["vocab_size"], sz["n_layers"]
    H, hd, kr, r = _sizes(sz)
    k = sz["first_dense_layers"]
    attn = d * H * (hd + kr) + d * (r + kr) + 2 * r * H * hd + H * hd * d
    moe = (3 * d * ff * (sz["experts_per_token"] + sz["n_shared_experts"])
           + d * sz["n_experts"])
    return L * attn + k * 3 * d * sz["dense_d_ff"] + (L - k) * moe + V * d


def attention_flops(sz: dict, positions: int) -> int:
    """2 x Hq x (hd + kr) for the scores and 2 x Hq x hd for the values,
    for each position attended to, in every layer (the model's own
    form: absorbing the up-projections at decode does more)."""
    H, hd, kr, _ = _sizes(sz)
    return sz["n_layers"] * 2 * H * (2 * hd + kr) * positions


def experts_reached(T: int, E: int, Kc: int) -> int:
    """Experts that T tokens reach, each choosing Kc of E uniformly:
    ``E (1 - (1 - Kc / E)^T)``, rounded down."""
    return int(E * (1.0 - (1.0 - Kc / E) ** T))


def moe_experts(T: int, sz: dict) -> tuple[int, int]:
    """One ``moe_experts`` call over T tokens: the weights of the
    experts they reach (gate, up, down; d x f each), the tokens in
    (T x d in the weights' type) and the float32 output (T x d); the
    three products of every token's K choices, ``6 T K d f``."""
    d, f = sz["d_model"], sz["d_ff"]
    e = _esize(sz["dtype"])
    Kc = sz["experts_per_token"]
    reached = experts_reached(T, sz["n_experts"], Kc)
    return (e * reached * 3 * d * f + e * T * d + 4 * T * d,
            6 * T * Kc * d * f)


def flash_mla(S: int, sz: dict, esize: int) -> tuple[int, int]:
    """The up-projected prefill of one sequence of S: q (Dk) and the
    output (Dv) per query head, k (Dk) and v (Dv) per head, each read
    or written once; Q K^T over Dk and P V over Dv for the causal
    pairs."""
    H, hd, kr, _ = _sizes(sz)
    Dk, Dv = hd + kr, hd
    pairs = S * (S + 1) // 2
    return esize * 2 * H * S * (Dk + Dv), 2 * H * pairs * (Dk + Dv)


def decode_mla(lengths, sz: dict, mix: dict) -> tuple[int, int]:
    """The absorbed decode over slots whose cache index is ``lengths``:
    q (G x (r + kr)) and the output (G x r) per slot in the model's type,
    each live latent row (r + kr) once in the cache's type, the (B,
    Smax) float32 bias; the scores over r + kr and P V over r for the
    live keys of every query head."""
    H, _, kr, r = _sizes(sz)
    B = len(lengths)
    live = sum(int(n) + 1 for n in lengths)
    q_e = _esize(sz["dtype"])
    kv_e = 4 if mix["cache_dtype"] == "float32" else 2
    return (q_e * B * H * (2 * r + kr) + kv_e * live * (r + kr)
            + 4 * B * mix["cache_positions"],
            2 * H * (2 * r + kr) * live)


def _mlps(T: int, sz: dict) -> list:
    """The fused MLP's calls a pass: the dense layers', then each MoE
    layer's shared experts."""
    d, e, bf = sz["d_model"], _esize(sz["dtype"]), peaks.flops_for(sz["dtype"])
    k, L = sz["first_dense_layers"], sz["n_layers"]
    sf = sz["n_shared_experts"] * sz["d_ff"]
    return ([(*K.fused_mlp(T, d, sz["dense_d_ff"], e), bf)] * k
            + [(*K.fused_mlp(T, d, sf, e), bf)] * (L - k))


def prefill_calls(sz: dict, mix: dict, S: int) -> dict:
    """The calls of one B = 1 prefill of ``S`` tokens."""
    e, bf = _esize(sz["dtype"]), peaks.flops_for(sz["dtype"])
    L, k = sz["n_layers"], sz["first_dense_layers"]
    return {"flash_attention": [(*flash_mla(S, sz, e), bf)] * L,
            "fused_mlp": _mlps(S, sz),
            "moe_experts": [(*moe_experts(S, sz), bf)] * (L - k)}


def decode_calls(sz: dict, mix: dict, lengths: list) -> dict:
    """The calls of one decode step over slots whose cache index is
    ``lengths``."""
    bf = peaks.flops_for(sz["dtype"])
    L, k, B = sz["n_layers"], sz["first_dense_layers"], len(lengths)
    return {"decode_attention": [(*decode_mla(lengths, sz, mix),
                                  peaks.flops_for(mix["cache_dtype"]))] * L,
            "fused_mlp": _mlps(B, sz),
            "moe_experts": [(*moe_experts(B, sz), bf)] * (L - k)}


def train_calls(sz: dict, mix: dict) -> dict:
    """No cell trains this family: ``moe_experts`` has no backward."""
    raise ValueError("deepseek_v2: no training cell (the routed experts' "
                     "kernel serves only)")
