"""The pass-based compiler driver: canonicalize -> validate -> partition
-> lower, behind one entry point.

Port of :mod:`repro.core.compiler`, with the same keywords plus
``device=``.  The phases: the :mod:`repro_torch.core.transform` pass
pipeline (unless ``strict=True``), validation, convex DAG fusion with
per-group tile selection (:func:`repro_torch.core.schedule.build_schedule`),
per-group lowering for the chosen backend
(:func:`repro_torch.core.fusion.lower_graph`) and the generated host
launcher (:func:`repro_torch.core.host.build_host_app`).
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch.core.fusion import lower_graph
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.host import CompiledApp, build_host_app
from repro_torch.core.schedule import build_schedule
from repro_torch.core.transform import Pass, PassPipeline
from repro_torch.core.vectorize import H100, GPUSpec
from repro_torch.device import NotPortedError, resolve_device
from repro_torch.obs.tracer import maybe_span, resolve_tracer

__all__ = ["compile_graph"]


def compile_graph(graph: DataflowGraph, backend="cuda_stream", *,
                  strict: bool = False, canonicalize: bool = True,
                  passes: Sequence[Pass] | PassPipeline | None = None,
                  mesh: Any = None, data_axis: str | Sequence[str] = "data",
                  donate: Sequence[str] = (), spec: GPUSpec | None = None,
                  vector_factor: int | None = None,
                  max_tile: tuple[int, int] | None = None,
                  tune: Any = None, tune_cache: Any = None,
                  calibrate: Any = None, interpret: bool | None = None,
                  jit: bool = True, trace: Any = None,
                  device: Any = None) -> CompiledApp:
    """Compile a dataflow graph end-to-end into a :class:`CompiledApp`.

    ``backend`` is a registered name (``"cuda_stream"``, ``"torch"``,
    ``"torch_staged"``) or a :class:`~repro_torch.backends.Backend`.
    ``device`` defaults to ``"cuda"``; without a card that raises
    :class:`~repro_torch.device.DeviceUnavailableError` — pass
    ``device="cpu"`` to run the plain versions on the CPU.  On the
    card, ``spec`` defaults to the constants the card reports.

    ``vector_factor`` pins every fused kernel's tile width to
    ``32 * factor``; ``max_tile`` caps the swept tile.  ``trace`` takes
    a :class:`~repro_torch.obs.tracer.Tracer` (or ``True``) and records
    ``compile.*`` spans.  ``jit`` has no effect (PyTorch runs eagerly)
    and ``data_axis`` only matters with a mesh.

    Not ported yet, and refused with
    :class:`~repro_torch.device.NotPortedError`: ``tune``/``tune_cache``
    (the autotuner), ``calibrate``, ``mesh`` (replication), ``donate``
    (every call allocates new outputs) and ``interpret=True`` (a CUDA
    kernel has no interpret mode; CPU tensors take the plain version).

    >>> from repro_torch.core.graph import DataflowGraph
    >>> g = DataflowGraph("doc")
    >>> x = g.input("img", (8, 128))
    >>> _ = g.output(g.point(x, lambda v: v * 3.0), "out")
    >>> app = compile_graph(g, backend="torch", device="cpu")
    >>> import torch
    >>> float(app(img=torch.ones(8, 128))["out"][0, 0])
    3.0
    """
    refused = {"tune": tune not in (None, "model"),
               "tune_cache": tune_cache is not None,
               "calibrate": calibrate not in (None, False),
               "mesh": mesh is not None, "donate": bool(donate),
               "interpret": bool(interpret)}
    for key, hit in refused.items():
        if hit:
            raise NotPortedError(
                f"compile_graph({key}=...) is not ported to repro_torch yet")
    dev = resolve_device(device)
    from repro_torch.backends import resolve
    be = resolve(backend)
    if spec is None:
        spec = GPUSpec.from_device(dev) if dev.type == "cuda" else H100
    tracer = resolve_tracer(trace)
    with maybe_span(tracer, "compile", cat="compile", graph=graph.name,
                    backend=be.name) as top:
        sched = build_schedule(
            graph, canonicalize=canonicalize, strict=strict, passes=passes,
            spec=spec, vector_factor=vector_factor, max_tile=max_tile,
            trace=tracer)
        with maybe_span(tracer, "compile.lower", cat="compile",
                        graph=graph.name, backend=be.name):
            run, sched = lower_graph(sched.graph, be, schedule=sched)
        with maybe_span(tracer, "compile.host", cat="compile",
                        graph=graph.name):
            app = build_host_app(sched, run, backend=be, device=dev)
        top.set(kernels=len(sched.groups), stages=len(sched.order))
    return app
