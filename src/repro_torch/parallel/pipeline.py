"""Pipeline parallelism: GPipe-style microbatched execution over a
``stage`` mesh axis (the port of :mod:`repro.parallel.pipeline`).

FLOWER's dataflow pipeline at the device scale: stages are devices, the
FIFO channel is the copy between neighbours, the items are
microbatches.  The same latency law holds (and the tests count it):
n_micro + n_stages - 1 steps, against n_micro x n_stages for sequential
execution.

The reference runs one program a device under ``shard_map`` and hands
each stage's output on with ``ppermute``.  The port is single-controller
(:mod:`repro_torch.parallel.collectives`): each step it runs every
stage's ``stage_fn`` on the tensor that stage holds, on the stage's
device, bubbles included, then copies each output to the next stage's
device.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel.collectives import ppermute
from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           ShardedTensor)

__all__ = ["pipeline_apply"]


def _stage_params(tree: Any, mesh: Mesh, axis: str, n_stages: int) -> list:
    """Stage s's parameters (leading dim of every leaf indexed at s) on
    stage s's device: the pieces of a leaf already split over ``axis``
    (a ``ShardedTensor`` of ``P(axis)``), else contiguous copies."""
    if isinstance(tree, dict):
        per = {k: _stage_params(tree[k], mesh, axis, n_stages)
               for k in sorted(tree)}
        return [{k: v[s] for k, v in per.items()} for s in range(n_stages)]
    if tree.shape[0] != n_stages:
        raise ValueError(f"a stacked parameter has leading dim "
                         f"{tree.shape[0]}, not the {n_stages} stages")
    if not (isinstance(tree, ShardedTensor) and tree.mesh is mesh
            and tuple(tree.sharding.spec) == (axis,)):
        tree = NamedSharding(mesh, P(axis)).shard(tree)
    return [t[0] for t in tree.pieces()]


def pipeline_apply(stage_fn: Callable, params_stacked: Any, x: torch.Tensor,
                   mesh: Mesh, n_micro: int, axis: str = "stage"
                   ) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages, pipelined.

    stage_fn(params_stage, x_micro) -> x_micro (same shape).
    params_stacked: a dict tree (or a tensor) with leading dim n_stages,
    stage s's slice placed on the device of position s of ``axis``
    (the mesh's other axes must be 1); leaves already split by
    ``NamedSharding(mesh, P(axis))`` are used where they lie.
    x: (batch, ...) with batch % n_micro == 0.

    GPipe schedule: microbatch m enters stage s at step m + s; every
    stage runs at every step on whatever the ring delivered (zeros in
    the bubbles), for n_micro + n_stages - 1 steps.  Returns the last
    stage's outputs, (batch, ...) on the last stage's device.
    """
    others = {n: s for n, s in mesh.shape.items() if n != axis and s != 1}
    if others:
        raise ValueError(f"the pipeline runs over {axis!r}; the mesh's "
                         f"other axes {others} must have size 1")
    devices = list(mesh.devices.reshape(-1))
    n_stages = len(devices)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    mb = B // n_micro
    params = _stage_params(params_stacked, mesh, axis, n_stages)
    micro = x.reshape(n_micro, mb, *x.shape[1:]).to(devices[0])
    out = torch.empty((n_micro, mb, *x.shape[1:]), dtype=x.dtype,
                      device=devices[-1])
    # hold[s]: the activation stage s owns this step
    hold = [torch.zeros((mb, *x.shape[1:]), dtype=x.dtype, device=d)
            for d in devices]
    n_steps = n_micro + n_stages - 1
    for t in range(n_steps):
        # stage 0 injects microbatch t (zeros once none remain)
        hold[0] = micro[t] if t < n_micro else torch.zeros_like(micro[0])
        ys = [stage_fn(params[s], hold[s]) for s in range(n_stages)]
        # the last stage retires microbatch t - (n_stages - 1)
        mi = t - (n_stages - 1)
        if 0 <= mi < n_micro:
            out[mi].copy_(ys[-1])
        # FIFO hand-off to the next stage
        hold = ppermute(ys, devices)
    return out.reshape(B, *x.shape[1:])
