"""Collectives of the single controller: the row-halo exchange, the ring
matmuls and the gradient reduce-scatter (the port of
:mod:`repro.parallel.collectives`).

The reference runs these inside ``shard_map``, one program a device,
and moves data between neighbours with ``ppermute``.  The port is
single-controller, as replication is: one process holds every shard as
a tensor on its mesh device and runs each device's part in turn, and a
``ppermute`` is a copy into a new tensor on the neighbour's device (a
peer copy between cards, a device-to-device copy when the two positions
share one card; never an alias of the neighbour's tensor).
``Tensor.copy_`` between cards orders itself against the current
streams of both devices.

The ring matmuls keep the reference's ring order: at step ``i`` shard
``idx`` multiplies the block produced by ``(idx - i) % P``
(all-gather), or adds the block owned by ``(idx - 1 - i) % P``
(reduce-scatter).  Their products are plain float32 ``x @ w``, as the
reference's ``jnp.dot`` outside any Pallas kernel.

The ring hops and the reduce-scatter report the bytes they move between
mesh positions to :mod:`repro_torch.parallel.traffic` (the dry run's
collective bytes); outside a dry run that is one context-variable read.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.parallel import traffic
from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           ShardedTensor)

__all__ = ["halo_exchange_rows", "ring_allgather_matmul",
           "ring_matmul_reducescatter", "ring_allgather_shards",
           "ring_reducescatter_shards", "ppermute", "reduce_scatter",
           "psum_scatter_grads"]


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


def ppermute(blocks: Sequence[torch.Tensor], devices: Sequence[Any]
             ) -> list[torch.Tensor]:
    """One ring hop: block ``j`` moves to position ``(j + 1) % P``, as a
    new tensor on that position's device (a real copy, also when the two
    positions share a device)."""
    P_ = len(blocks)
    out = [None] * P_
    for j, b in enumerate(blocks):
        dst = (j + 1) % P_
        t = torch.empty(b.shape, dtype=b.dtype, device=devices[dst])
        out[dst] = t.copy_(b)
    if traffic.active():
        traffic.report("collective-permute",
                       sum(b.numel() * b.element_size() for b in blocks))
    return out


def ring_allgather_shards(xs: Sequence[torch.Tensor],
                          ws: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Column-parallel matmul with the input's row blocks streamed
    around the ring.  ``xs[j]`` (m/P, k) and ``ws[j]`` (k, n/P) live on
    position ``j``'s device; returns each position's (m, n/P) column
    block, in ``xs``' type.  The products are float32; the ring makes
    P - 1 hops (the reference's last hop carries a block nobody reads,
    so it is not made)."""
    P_ = len(xs)
    devices = [x.device for x in xs]
    mb = xs[0].shape[0]
    ws32 = [w.to(torch.float32) for w in ws]
    outs = [torch.empty((mb * P_, w.shape[1]), dtype=torch.float32,
                        device=w.device) for w in ws]
    blks = list(xs)
    for i in range(P_):
        for idx in range(P_):
            owner = (idx - i) % P_            # who produced blks[idx]
            torch.matmul(blks[idx].to(torch.float32), ws32[idx],
                         out=outs[idx][owner * mb:(owner + 1) * mb])
        if i < P_ - 1:
            blks = ppermute(blks, devices)
    return [o.to(xs[0].dtype) for o in outs]


def ring_reducescatter_shards(xs: Sequence[torch.Tensor],
                              ws: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """Row-parallel matmul with the output's reduce-scatter streamed
    around the ring.  ``xs[j]`` (m, k/P) and ``ws[j]`` (k/P, n) live on
    position ``j``'s device; ``partial_j = xs[j] @ ws[j]`` (float32) is
    summed over the positions, and position ``j`` ends with row block
    ``j`` (m/P, n) of the sum, in ``xs``' type."""
    P_ = len(xs)
    devices = [x.device for x in xs]
    parts = [x.to(torch.float32) @ w.to(torch.float32)
             for x, w in zip(xs, ws)]
    mb = parts[0].shape[0] // P_

    def blk(idx, i):
        # the acc held at idx at step i has P-1-i hops left; it ends at
        # shard idx-1-i, so it adds that destination's row block
        owner = (idx - 1 - i) % P_
        return parts[idx][owner * mb:(owner + 1) * mb]

    acc = [blk(idx, 0).clone() for idx in range(P_)]
    for i in range(1, P_):
        acc = ppermute(acc, devices)
        for idx in range(P_):
            acc[idx].add_(blk(idx, i))
    return [a.to(xs[0].dtype) for a in acc]


def _ring_devices(mesh: Mesh, axis: str) -> list:
    """The devices along ``axis``; the mesh's other axes must be 1."""
    others = {n: s for n, s in mesh.shape.items() if n != axis and s != 1}
    if others:
        raise ValueError(f"the ring runs over {axis!r}; the mesh's other "
                         f"axes {others} must have size 1")
    return list(mesh.devices.reshape(-1))


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                          axis: str = "model") -> torch.Tensor:
    """``x @ w`` with x (m, k) row-split and w (k, n) column-split over
    ``axis`` (:func:`ring_allgather_shards`); returns the (m, n) result
    on ``x``'s device."""
    _ring_devices(mesh, axis)
    xs = NamedSharding(mesh, P(axis, None)).shard(x).pieces()
    ws = NamedSharding(mesh, P(None, axis)).shard(w).pieces()
    outs = ring_allgather_shards(xs, ws)
    return torch.cat([o.to(x.device) for o in outs], dim=1)


def ring_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                              axis: str = "model") -> torch.Tensor:
    """``x @ w`` with x (m, k) column-split and w (k, n) row-split over
    ``axis`` (:func:`ring_reducescatter_shards`); returns the (m, n)
    result on ``x``'s device."""
    _ring_devices(mesh, axis)
    xs = NamedSharding(mesh, P(None, axis)).shard(x).pieces()
    ws = NamedSharding(mesh, P(axis, None)).shard(w).pieces()
    outs = ring_reducescatter_shards(xs, ws)
    return torch.cat([o.to(x.device) for o in outs], dim=0)


def reduce_scatter(parts: Sequence[torch.Tensor], sharding: NamedSharding
                   ) -> ShardedTensor:
    """The float32 sum of ``parts`` (one a data shard, whole tensors; the
    first held at the mesh's first position), added in ascending order on
    the first part's device, split by ``sharding``: each mesh position
    ends with the slice it owns."""
    total = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        total.add_(p.to(total.device, torch.float32))
    out = sharding.shard(total)
    if traffic.active():
        first = next(sharding.mesh.positions())
        traffic.report("reduce-scatter", sum(
            p.numel() * p.element_size() for p in parts[1:])
            + sum(out.nbytes_at(pos) for pos in sharding.mesh.positions()
                  if pos != first))
    return out


def psum_scatter_grads(grads: Sequence[Any], mesh: Mesh,
                       axis: str = "data") -> list:
    """Leaf-wise reduce-scatter of gradient trees (one a shard of
    ``axis``, each a dict tree of tensors): shard ``j`` ends with rows
    block ``j`` (dim 0, tiled) of the leaves' sum over the shards, on its
    device, as ``jax.lax.psum_scatter(g, axis, scatter_dimension=0,
    tiled=True)``.  Returns one tree a shard."""
    one_d = Mesh(_ring_devices(mesh, axis), (axis,))
    sharding = NamedSharding(one_d, P(axis))

    def walk(leaves):
        if isinstance(leaves[0], dict):
            per = {k: walk([t[k] for t in leaves]) for k in sorted(leaves[0])}
            return [{k: v[j] for k, v in per.items()}
                    for j in range(len(leaves))]
        return reduce_scatter(leaves, sharding).pieces()

    return walk(list(grads))
