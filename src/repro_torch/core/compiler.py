"""The pass-based compiler driver: canonicalize -> validate -> partition
-> lower, behind one entry point.

Port of :mod:`repro.core.compiler`, with the same keywords plus
``device=``.  The phases: the :mod:`repro_torch.core.transform` pass
pipeline (unless ``strict=True``), validation, convex DAG fusion with
per-group tile selection (:func:`repro_torch.core.schedule.build_schedule`:
the analytic sweep, an explicit ``vector_factor=``, or the measured
autotuner of :mod:`repro_torch.tune` with ``tune="auto"``), per-group
lowering for the chosen backend
(:func:`repro_torch.core.fusion.lower_graph`) and the generated host
launcher (:func:`repro_torch.core.host.build_host_app`).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core.fusion import lower_graph
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.host import (CompiledApp, build_host_app,
                                   replicated_host_app)
from repro_torch.core.schedule import build_schedule
from repro_torch.core.transform import Pass, PassPipeline
from repro_torch.core.vectorize import GPUSpec, device_spec
from repro_torch.device import resolve_device
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

    ``tune`` upgrades tile selection from *modeled* to *measured*:
    ``"auto"`` consults the persistent
    :class:`~repro_torch.tune.store.TuningCache` (``tune_cache``, default
    on-disk location) and on a miss runs the measured search
    (:func:`repro_torch.tune.search.tune_graph`: the analytic pick and
    the model's short-list, each built and timed on ``device``) and
    persists the winner; a :class:`~repro_torch.tune.store.ScheduleConfig`
    applies a known config verbatim.  ``tune`` is mutually exclusive
    with ``vector_factor`` and ``max_tile``.  ``calibrate`` swaps the
    data-sheet constants for fitted ones
    (:mod:`repro_torch.tune.calibrate`): ``"auto"`` loads the
    :class:`~repro_torch.tune.calibrate.CalibratedSpec` persisted for
    this backend and device kind, a spec applies verbatim, ``None``
    keeps the seed constants and cache keys.  An explicit ``spec=``
    still wins over calibration.

    ``mesh`` (a :class:`~repro_torch.parallel.sharding.ReplicaMesh`)
    row-partitions every call over the mesh axis ``data_axis``: the app
    runs through :func:`~repro_torch.parallel.replicate.replicate_app`'s
    launcher, one replica a mesh device, with the schedule knobs and
    ``tune`` applied to the replicas' local extended plane; outputs
    equal the unsharded app's bit for bit, and a graph replication
    refuses raises the same :class:`~repro_torch.core.graph.GraphError`.
    ``app.mesh`` records the mesh, ``app.replicated`` the replicated app,
    ``app.kernels`` its kernels; such an app has no batched entry.
    ``donate`` names inputs whose buffers the caller gives up; it has no
    effect (every call allocates its outputs) but shows in the buffer
    declarations, and a name that is not an input raises.
    ``interpret=True`` lowers every group to its plain version (no CUDA
    kernel) on the app's device, as an explicit request; a CUDA kernel
    has no interpret mode, and CPU tensors take the plain version
    anyway.

    >>> from repro_torch.core.graph import DataflowGraph
    >>> g = DataflowGraph("doc")
    >>> x = g.input("img", (8, 128))
    >>> _ = g.output(g.point(x, lambda v: v * 3.0), "out")
    >>> app = compile_graph(g, backend="torch", device="cpu")
    >>> import torch
    >>> float(app(img=torch.ones(8, 128))["out"][0, 0])
    3.0
    """
    if tune == "model":                 # explicit name for the default
        tune = None
    if tune is not None and vector_factor is not None:
        raise ValueError(
            "tune= and vector_factor= are mutually exclusive: the tuner "
            "owns the vector factors it measures")
    if tune is not None and max_tile is not None:
        raise ValueError(
            "tune= and max_tile= are mutually exclusive: the tile cap is "
            "one of the tuner's search axes (and part of the cached "
            "config); pass max_tile_candidates to tune_graph instead")
    axis = data_axis if isinstance(data_axis, str) else data_axis[0]
    if mesh is not None:
        if axis not in mesh.axis_names:
            raise ValueError(f"data_axis {axis!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
        if device is None:
            device = mesh.devices[0]
        elif torch.device(device).type != mesh.devices[0].type:
            raise ValueError(f"device {device!r} is not of the mesh's type "
                             f"({mesh.devices[0].type})")
    dev = resolve_device(device)
    from repro_torch.backends import resolve_calibrated
    from repro_torch.tune.store import detect_device_kind
    be = resolve_calibrated(backend, calibrate,
                            device_kind=detect_device_kind(dev))
    spec = spec or be.spec or device_spec(dev)
    tracer = resolve_tracer(trace)
    with maybe_span(tracer, "compile", cat="compile", graph=graph.name,
                    backend=be.name) as top:
        if mesh is not None:
            from repro_torch.parallel.replicate import replicate_app
            with maybe_span(tracer, "compile.replicate", cat="compile",
                            graph=graph.name, replicas=mesh.size):
                rep = replicate_app(
                    graph, mesh.size, backend=be, axis=axis,
                    devices=list(mesh.devices), canonicalize=canonicalize,
                    strict=strict, passes=passes, spec=spec,
                    vector_factor=vector_factor, max_tile=max_tile,
                    tune=tune, tune_cache=tune_cache, interpret=interpret)
            top.set(kernels=len(rep.schedule.groups),
                    stages=len(rep.schedule.order))
            return replicated_host_app(graph, rep, mesh, backend=be,
                                       device=dev, donate=donate)
        tuned = None
        if tune is not None:
            from repro_torch.tune.search import (resolve_tuning,
                                                 tuned_schedule_kwargs)
            with maybe_span(tracer, "compile.tune", cat="compile",
                            graph=graph.name):
                tuned = resolve_tuning(graph, be, tune=tune, spec=spec,
                                       cache=tune_cache, device=dev,
                                       strict=strict,
                                       canonicalize=canonicalize,
                                       passes=passes, trace=tracer)
        if tuned is not None:
            config, source, notes = tuned
            sched = build_schedule(
                graph, canonicalize=canonicalize, strict=strict,
                passes=passes, trace=tracer,
                **tuned_schedule_kwargs(config, source, spec))
            sched.diagnostics.extend(notes)
        else:
            sched = build_schedule(
                graph, canonicalize=canonicalize, strict=strict,
                passes=passes, spec=spec, vector_factor=vector_factor,
                max_tile=max_tile, trace=tracer)
        with maybe_span(tracer, "compile.lower", cat="compile",
                        graph=graph.name, backend=be.name):
            run, sched = lower_graph(sched.graph, be, schedule=sched,
                                     interpret=interpret)
        with maybe_span(tracer, "compile.host", cat="compile",
                        graph=graph.name):
            app = build_host_app(sched, run, backend=be, device=dev,
                                 donate=donate)
        top.set(kernels=len(sched.groups), stages=len(sched.order))
    return app
