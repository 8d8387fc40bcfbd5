"""Top-level kernel generation (FLOWER contribution C2).

Port of :mod:`repro.core.fusion`.  Lowers a :class:`FusionGroup` for
one of the port's backends:

- ``torch``        — the stages composed as torch ops on whole planes
                     (:func:`lower_group_torch`);
- ``torch_staged`` — the same with every stage output, split arms
                     included, materialized as its own plane: the
                     paper's *AnyHLS / no-dataflow* baseline;
- ``cuda_stream``  — THE paper artifact: one generated CUDA kernel per
                     group (:func:`lower_group_kernel`,
                     :mod:`repro_torch.kernels.stream_group`) that
                     streams tiles through shared memory.

Boundary semantics are zero padding on every backend: inside the
kernel every stage output is masked to zero outside the image, which
reproduces the reference's per-stage padding at tile borders.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.graph import (Channel, DataflowGraph,
                                    _apply_stage_reference, as_dtype,
                                    window_rows)
from repro_torch.core.schedule import FusionGroup, Schedule, build_schedule
from repro_torch.core.vectorize import GPUSpec

__all__ = ["lower_group", "lower_graph", "lower_group_torch",
           "lower_group_kernel"]


def lower_group_torch(group: FusionGroup, staged: bool = False,
                      valid_rows: tuple[int, int] | None = None) -> Callable:
    """Compose the group's stages as whole-plane torch ops.

    Eager PyTorch already writes every op's result to device memory;
    ``staged=True`` also gives each split arm its own copy, so every
    channel of the graph round-trips memory as the AnyHLS baseline's
    disjoint IP blocks do.  ``valid_rows=(r0, r1)`` zeroes every stage
    output outside that row band (a window of a larger plane).
    """

    def run(env_in: dict[Channel, Any]) -> dict[Channel, Any]:
        env = dict(env_in)
        for st in group.stages:
            outs = _apply_stage_reference(st, [env[c] for c in st.inputs])
            outs = [o.to(as_dtype(c.dtype)) for o, c in zip(outs, st.outputs)]
            if valid_rows is not None:
                outs = [window_rows(o, valid_rows) for o in outs]
            if staged and st.kind == "split":
                outs = [o.clone() for o in outs]
            env.update(zip(st.outputs, outs))
        return {ch: env[ch] for ch in group.outputs}

    return run


def lower_group_kernel(group: FusionGroup,
                       valid_rows: tuple[int, int] | None = None) -> Callable:
    """Lower a fusible group to its generated CUDA kernel.

    The source is generated (and every stage body recorded) here, so an
    unsupported stage fails at compile time on any host; the library is
    built at the first launch on the card.
    """
    from repro_torch.kernels.stream_group import GroupKernel, stream_group
    kernel = GroupKernel(group)

    def run(env_in: dict[Channel, Any]) -> dict[Channel, Any]:
        outs = stream_group(kernel, [env_in[c] for c in group.inputs],
                            valid_rows)
        return dict(zip(group.outputs, outs))

    run.kernel = kernel
    return run


def lower_group(group: FusionGroup, backend,
                valid_rows: tuple[int, int] | None = None) -> Callable:
    """Lower one fusion group through the backend registry."""
    from repro_torch.backends import resolve
    return resolve(backend).lower_group(group, valid_rows=valid_rows)


def lower_graph(graph: DataflowGraph, backend="cuda_stream",
                schedule: Schedule | None = None,
                spec: GPUSpec | None = None,
                vector_factor: int | None = None, *,
                canonicalize: bool = True, strict: bool = False,
                max_tile: tuple[int, int] | None = None,
                valid_rows: tuple[int, int] | None = None,
                interpret: bool | None = None,
                ) -> tuple[Callable, Schedule]:
    """Lower a whole dataflow graph; returns ``(run, schedule)``.

    ``run`` maps ``{input_name: tensor} -> {output_name: tensor}`` on
    whatever device the inputs lie on, and carries the generated
    kernels of its groups as ``run.kernels``.  ``run.batched`` does the
    same for a batch: every input and output gains a leading axis of
    ``B`` frames.  A kernel group launches once for all ``B``; a group
    composed of torch ops (the ``torch`` backends, trivial groups) runs
    frame by frame.  ``interpret=True`` lowers every group to its plain
    version (no kernel), on whatever device the inputs lie.  Unless a
    pre-built ``schedule`` is passed, the
    graph is canonicalized and partitioned first
    (:func:`repro_torch.core.schedule.build_schedule`).
    """
    from repro_torch.backends import resolve
    be = resolve(backend)
    sched = schedule or build_schedule(graph, canonicalize=canonicalize,
                                       strict=strict, spec=spec,
                                       vector_factor=vector_factor,
                                       max_tile=max_tile)
    graph = sched.graph
    fns = [be.lower_group(g, valid_rows=valid_rows, interpret=bool(interpret))
           for g in sched.groups]

    def graph_run(group_fns: list[Callable]) -> Callable:
        def run(inputs: dict[str, Any]) -> dict[str, Any]:
            env: dict[Channel, Any] = {}
            for ch in graph.graph_inputs:
                env[ch] = torch.as_tensor(inputs[ch.name],
                                          dtype=as_dtype(ch.dtype))
            for fn, g in zip(group_fns, sched.groups):
                env.update(fn({ch: env[ch] for ch in g.inputs}))
            return {ch.name: env[ch] for ch in graph.graph_outputs}
        return run

    run = graph_run(fns)
    run.batched = graph_run([f if hasattr(f, "kernel") else _frame_by_frame(f)
                             for f in fns])
    run.kernels = [f.kernel for f in fns if hasattr(f, "kernel")]
    return run, sched


def _frame_by_frame(fn: Callable) -> Callable:
    """A group function over single frames, run over each frame of a
    ``(B, ...)`` batch in turn and the outputs stacked."""

    def run(env_in: dict[Channel, Any]) -> dict[Channel, Any]:
        n = next(iter(env_in.values())).shape[0]
        frames = [fn({ch: x[b] for ch, x in env_in.items()})
                  for b in range(n)]
        return {ch: torch.stack([f[ch] for f in frames]) for ch in frames[0]}

    return run
