"""Counts of the dense decoder family (granite-3-2b): its model FLOPs
and the kernel calls its layers make.

Every layer has the same projections (q, k, v, o; gate, up, down) and
calls flash attention at a prefill and in training, decode attention at
a decode step, and the fused MLP in each, once a layer.  Each call is
``(bytes, flops, peak)`` (``bench.counts.kernels``), the products at the
peak of the configuration's weight type, decode attention's at the
cache's.
"""
from __future__ import annotations

from bench.counts import kernels as K
from bench.counts import peaks


def head_dim(sz: dict) -> int:
    return sz.get("head_dim") or sz["d_model"] // sz["n_heads"]


def weights_per_token(sz: dict) -> int:
    """Weight elements one token is multiplied by: every layer's
    projections and the unembedding."""
    d, ff, V = sz["d_model"], sz["d_ff"], sz["vocab_size"]
    Hq, Hkv, hd = sz["n_heads"], sz["n_kv_heads"], head_dim(sz)
    attn = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
    mlp = 3 * d * ff
    return sz["n_layers"] * (attn + mlp) + V * d


def attention_flops(sz: dict, positions: int) -> int:
    """2 x 2 x Hq x hd for each position attended to, in every layer."""
    return sz["n_layers"] * 4 * sz["n_heads"] * head_dim(sz) * positions


def _esize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def prefill_calls(sz: dict, mix: dict, S: int) -> dict:
    """The calls of one B = 1 prefill of ``S`` tokens."""
    Hq, Hkv, L = sz["n_heads"], sz["n_kv_heads"], sz["n_layers"]
    e, bf = _esize(sz["dtype"]), peaks.flops_for(sz["dtype"])
    return {"flash_attention": [(*K.flash_attention(
                1, S, S, Hq, Hkv, head_dim(sz), e), bf)] * L,
            "fused_mlp": [(*K.fused_mlp(S, sz["d_model"], sz["d_ff"], e),
                           bf)] * L}


def decode_calls(sz: dict, mix: dict, lengths: list) -> dict:
    """The calls of one decode step over slots whose cache index is
    ``lengths``."""
    Hq, Hkv, L = sz["n_heads"], sz["n_kv_heads"], sz["n_layers"]
    e, bf = _esize(sz["dtype"]), peaks.flops_for(sz["dtype"])
    kv = mix["cache_dtype"]
    return {"decode_attention": [(*K.decode_attention(
                lengths, mix["cache_positions"], Hq, Hkv, head_dim(sz), e,
                4 if kv == "float32" else 2), peaks.flops_for(kv))] * L,
            "fused_mlp": [(*K.fused_mlp(len(lengths), sz["d_model"],
                                        sz["d_ff"], e), bf)] * L}


def train_calls(sz: dict, mix: dict) -> dict:
    """The calls of one training forward of the mix's batch."""
    B, S = mix["batch"], mix["seq_len"]
    Hq, Hkv, L = sz["n_heads"], sz["n_kv_heads"], sz["n_layers"]
    e, bf = _esize(sz["dtype"]), peaks.flops_for(sz["dtype"])
    return {"flash_attention": [(*K.flash_attention(
                B, S, S, Hq, Hkv, head_dim(sz), e), bf)] * L,
            "fused_mlp": [(*K.fused_mlp(B * S, sz["d_model"], sz["d_ff"], e),
                           bf)] * L}
