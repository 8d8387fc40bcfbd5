"""Int8 gradient compression with error feedback (the port of
``repro.optim.compression``).

Each gradient plus its carried error is quantized to int8 with one
scale per tensor, round half to even as ``jnp.round``; what the int8
payload misses is carried to the next step.  ``ef_roundtrip`` writes
the new errors into the error tree IN PLACE, where the reference
returns a new tree.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = ["ef_init", "compress", "decompress", "ef_roundtrip"]


def ef_init(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + err -> (int8 q, scale, new_err)."""
    corrected = g.to(torch.float32) + err
    scale = corrected.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(
        torch.int8)
    new_err = corrected - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def ef_roundtrip(grads: Any, err_state: Any) -> tuple[Any, Any]:
    """Compress and decompress every leaf (in each gradient's type); the
    new errors go into ``err_state`` in place.  ``grads`` is a tree like
    ``err_state`` or its leaves in sorted-key order (then a list comes
    back).  Returns (grads', err_state)."""
    flat = grads if isinstance(grads, list) else tree_leaves(grads)
    outs = []
    for g, e in zip(flat, tree_leaves(err_state)):
        q, s, new_err = compress(g, e)
        e.copy_(new_err)
        outs.append(decompress(q, s).to(g.dtype))
    if isinstance(grads, list):
        return outs, err_state
    it = iter(outs)
    return tree_map(lambda _g: next(it), grads), err_state
