"""Int8 gradient compression with error feedback (the port of
``repro.optim.compression``).

Each gradient plus its carried error is quantized to int8 with one
scale per tensor, round half to even as ``jnp.round``; what the int8
payload misses is carried to the next step.  ``ef_roundtrip`` writes
the new errors into the error tree IN PLACE, where the reference
returns a new tree.  Over ``ShardedTensor`` leaves (a sharded step's
reduced gradients and the error feedback split like the parameters)
the scale is the whole tensor's, the max over its distinct pieces, and
each mesh position quantizes its own pieces: the same payload and
errors as one device's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import each_piece, tree_leaves, tree_map

__all__ = ["ef_init", "compress", "decompress", "ef_roundtrip"]


def ef_init(grads_like: Any) -> Any:
    return tree_map(lambda g: each_piece(g, lambda t: torch.zeros(
        t.shape, dtype=torch.float32, device=t.device)), grads_like)


def compress(g: torch.Tensor, err: torch.Tensor,
             scale: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + err -> (int8 q, scale, new_err); ``scale`` given: that one
    (a sharded tensor's, from all its pieces)."""
    corrected = g.to(torch.float32) + err
    if scale is None:
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
        if isinstance(g, torch.Tensor):
            q, s, new_err = compress(g, e)
            e.copy_(new_err)
            outs.append(decompress(q, s).to(g.dtype))
            continue
        # the whole tensor's scale: the max over its distinct pieces
        amax = [(gp.to(torch.float32) + ep).abs().max() for gp, ep in zip(
            g.leader_pieces(), e.leader_pieces())]
        s = (torch.stack([a.to(amax[0].device) for a in amax]).max()
             .clamp_min(1e-12) / 127.0)
        deq = []
        for gp, ep in zip(g.pieces(), e.pieces()):
            q, sp, new_err = compress(gp, ep, s.to(gp.device))
            ep.copy_(new_err)
            deq.append(decompress(q, sp).to(gp.dtype))
        it = iter(deq)                 # map visits the pieces in order
        outs.append(g.map(lambda _: next(it)))
    if isinstance(grads, list):
        return outs, err_state
    it = iter(outs)
    return tree_map(lambda _g: next(it), grads), err_state
