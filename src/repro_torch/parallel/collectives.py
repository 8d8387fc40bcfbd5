"""Row-halo exchange between the replicas of a row-partitioned plane.

Port of :func:`repro.parallel.collectives.halo_exchange_rows`.  The
reference runs inside ``shard_map`` and moves each shard's edge rows
with two ``ppermute``s; the port is single-controller as well, so the
exchange is a row copy from each neighbour's tensor into the extended
shard: a peer copy when the two replicas sit on different cards, a
slice copy when they share one.  ``Tensor.copy_`` between cards orders
itself against the current streams of both devices.  The ring matmuls
and ``psum_scatter_grads`` are not ported yet (``ROADMAP.md`` A9).
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["halo_exchange_rows"]


def halo_exchange_rows(shards: Sequence[torch.Tensor],
                       hy: int) -> list[torch.Tensor]:
    """Extend each of the k row shards by ``hy`` rows above and below.

    ``shards[j]`` holds rows ``[j*h, (j+1)*h)`` of the plane on replica
    ``j``'s device; the result ``j`` holds ``h + 2*hy`` rows on the same
    device: ``hy`` rows of shard ``j-1``, shard ``j``, ``hy`` rows of
    shard ``j+1``.  The top shard's upper halo and the bottom shard's
    lower halo have no neighbour and are zeros, the compiler's
    zero-padding boundary, so a replicated app reproduces the
    single-device app bit for bit.  ``hy == 0`` returns the shards as
    they are.
    """
    shards = list(shards)
    if hy == 0:
        return shards
    if hy < 0:
        raise ValueError(f"hy must be >= 0, got {hy}")
    for j, x in enumerate(shards):
        if x.shape[0] < hy:
            raise ValueError(f"shard {j} has {x.shape[0]} rows, fewer than "
                             f"the {hy}-row halo")
    out = []
    last = len(shards) - 1
    for j, x in enumerate(shards):
        h = x.shape[0]
        ext = x.new_empty((h + 2 * hy, *x.shape[1:]))
        if j > 0:
            ext[:hy].copy_(shards[j - 1][-hy:])
        else:
            ext[:hy].zero_()
        ext[hy:hy + h].copy_(x)
        if j < last:
            ext[hy + h:].copy_(shards[j + 1][:hy])
        else:
            ext[hy + h:].zero_()
        out.append(ext)
    return out
