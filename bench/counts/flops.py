"""Model FLOPs of a decoder, from a configuration's sizes.

The rule is ``src/repro_torch/analysis/roofline.py``'s ``model_flops``
(6 N T for a training step: forward 2 N T, backward 4 N T), frozen here
with two refinements that the issue asked for:

- N counts the weights a token is multiplied by: every projection of
  every block it passes and the unembedding; the embedding lookup and
  the norms cost no product.
- Attention adds its score and value products for each position a
  query attends to, in every attention layer.

Both come from the family (``bench/counts/families/<family>.py``, found
by ``sz["family"]``): ``weights_per_token(sz)`` (with sparse experts,
those a token passes through) and ``attention_flops(sz, positions)``.
Recomputed operations (remat) are not counted: model FLOPs, not
hardware FLOPs.
"""
from __future__ import annotations

from bench import families


def weights_per_token(sz: dict) -> int:
    """Weight elements one token is multiplied by, at every site."""
    return families.counts(sz["family"]).weights_per_token(sz)


def attention_flops(sz: dict, positions: int) -> int:
    """Score and value products of one token that attends to
    ``positions`` positions, over every attention layer."""
    return families.counts(sz["family"]).attention_flops(sz, positions)


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
