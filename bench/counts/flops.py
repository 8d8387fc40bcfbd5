"""Model FLOPs of the dense decoder family, from a configuration's sizes.

The rule is ``src/repro_torch/analysis/roofline.py``'s ``model_flops``
(6 N T for a training step: forward 2 N T, backward 4 N T), frozen here
with two refinements that the issue asked for:

- N counts the weights a token is multiplied by: every projection of
  every block it passes and the unembedding; the embedding lookup and
  the norms cost no product.
- Attention adds its score and value products, 2 x 2 x Hq x hd FLOPs
  for each position a query attends to, in every attention layer.

Recomputed operations (remat) are not counted: model FLOPs, not
hardware FLOPs.
"""
from __future__ import annotations


def head_dim(sz: dict) -> int:
    return sz.get("head_dim") or sz["d_model"] // sz["n_heads"]


def weights_per_token(sz: dict) -> int:
    """Weight elements one token is multiplied by, at every site."""
    d, ff, V = sz["d_model"], sz["d_ff"], sz["vocab_size"]
    hd = head_dim(sz)
    Hq, Hkv = sz["n_heads"], sz["n_kv_heads"]
    attn = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
    mlp = 3 * d * ff
    if sz["family"] == "dense":
        return sz["n_layers"] * (attn + mlp) + V * d
    raise ValueError(f"no FLOP count for family {sz['family']!r}")


def attention_flops(sz: dict, positions: int) -> int:
    """Score and value products of one token that attends to
    ``positions`` positions, over every attention layer."""
    return sz["n_layers"] * 4 * sz["n_heads"] * head_dim(sz) * positions


def prompt_flops(sz: dict, S: int) -> int:
    """Forward FLOPs of a causal prompt of ``S`` tokens."""
    return 2 * weights_per_token(sz) * S + attention_flops(
        sz, S * (S + 1) // 2)


def decode_flops(sz: dict, lengths) -> int:
    """Forward FLOPs of one decode step for the slots whose cache index
    is ``lengths`` (each attends to length + 1 positions)."""
    return sum(2 * weights_per_token(sz) + attention_flops(sz, int(n) + 1)
               for n in lengths)


def train_step_flops(sz: dict, B: int, S: int) -> int:
    """Forward and backward of ``B`` causal sequences of ``S`` tokens:
    three times the forward."""
    return 3 * B * prompt_flops(sz, S)
