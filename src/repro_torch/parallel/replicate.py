"""Spatial replication of compiled dataflow apps (FLOWER "replication").

Port of :mod:`repro.parallel.replicate`.  The paper's
hardware-parallelism taxonomy has two axes: *vectorization* widens one
processing element's datapath (:mod:`repro_torch.core.vectorize`),
*replication* instantiates the whole pipeline k times and feeds each
copy a slice of the plane.  Here the copies are the devices of a 1-D
:class:`~repro_torch.parallel.sharding.ReplicaMesh`, and the plane is
row-partitioned.

Stencil stages need rows owned by the neighbouring shard: the
replicator computes the graph-wide cumulative halo, recompiles the app
once for the halo-extended local plane, and exchanges halo rows
between the replicas before every launch
(:func:`repro_torch.parallel.collectives.halo_exchange_rows`).
Missing neighbours at the global top and bottom contribute zeros, the
compiler's zero-padding boundary, and every stage output is masked to
the rows that lie inside the image (``valid_rows``), so a replicated
app is bit-exact against the single-device app.

The port is single-controller, as ``shard_map`` is: ``rep(img=x)``
takes the global plane and returns the global plane, and one process
drives the k replicas.  Where the reference picks each replica's edge
variant with ``jax.lax.switch`` on ``axis_index``, the port picks the
lowered variant of each replica in Python: ``(hy, he)`` at the top,
``(0, he)`` in the middle, ``(0, hy + h_local)`` at the bottom, and
``(hy, hy + h_local)`` for one replica.  The variants differ only in
the kernels' ``valid_rows`` argument, so they share one build per
extended plane.  Outputs are gathered into one global plane on the
mesh's first device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Any, Callable

import torch

from repro_torch.backends import resolve, resolve_calibrated
from repro_torch.core.fusion import lower_graph
from repro_torch.core.graph import Channel, DataflowGraph, GraphError, as_dtype
from repro_torch.core.host import CompiledApp, LaunchHandle
from repro_torch.core.schedule import Schedule, build_schedule
from repro_torch.core.vectorize import device_spec
from repro_torch.parallel.collectives import halo_exchange_rows
from repro_torch.parallel.sharding import ReplicaMesh, replica_mesh

__all__ = ["ReplicatedApp", "replicate_app", "graph_input_halo",
           "replication_kwarg_routing", "UNROUTED_COMPILE_KWARGS"]

#: ``compile_graph`` knobs replication deliberately does NOT forward:
#: the sharded launcher replaces the generated host launcher (mesh /
#: data_axis / donate / jit), the mesh fixes the devices (device), and
#: tracing is engine-level plumbing.  Everything else in
#: ``compile_graph``'s signature must route into the scheduler or the
#: lowering — ``replication_kwarg_routing`` derives that split from the
#: live signatures, and a test asserts full coverage so a NEW compile
#: kwarg cannot be silently dropped.
UNROUTED_COMPILE_KWARGS = frozenset(
    {"mesh", "data_axis", "donate", "jit", "trace", "device"})

#: kwargs consumed by the tuning/calibration resolution steps
#: themselves (not by the scheduler/lowering signatures)
_TUNE_KWARGS = frozenset({"tune", "tune_cache", "calibrate"})


def replication_kwarg_routing() -> tuple[frozenset, frozenset, frozenset]:
    """Derive ``(known, sched, lower)`` kwarg sets from live signatures.

    ``known`` is every ``compile_graph`` keyword ``replicate_app``
    accepts; ``sched``/``lower`` are the subsets forwarded to
    :func:`~repro_torch.core.schedule.build_schedule` and
    :func:`~repro_torch.core.fusion.lower_graph`.
    """
    from repro_torch.core.compiler import compile_graph
    all_kwargs = frozenset(
        inspect.signature(compile_graph).parameters) - {"graph", "backend"}
    routable = all_kwargs - UNROUTED_COMPILE_KWARGS - _TUNE_KWARGS
    sched = routable & frozenset(
        inspect.signature(build_schedule).parameters)
    lower = routable & frozenset(
        inspect.signature(lower_graph).parameters)
    return sched | lower | _TUNE_KWARGS, sched, lower


def graph_input_halo(graph: DataflowGraph) -> dict[Channel, tuple[int, int]]:
    """Cumulative (hy, hx) halo each *graph input* must carry.

    Backward DP over the whole stage DAG: intermediate planes that
    round-trip through device memory still shrink the valid region of a
    row-partitioned shard, so replication provisions for the end-to-end
    stencil radius, not the per-kernel one.
    """
    halo: dict[Channel, tuple[int, int]] = {}
    for st in reversed(graph.toposort()):
        out_halos = [halo.get(ch, (0, 0)) for ch in st.outputs]
        oh = (max(h[0] for h in out_halos), max(h[1] for h in out_halos))
        ih = (oh[0] + st.halo[0], oh[1] + st.halo[1])
        for ch in st.inputs:
            prev = halo.get(ch, (0, 0))
            halo[ch] = (max(prev[0], ih[0]), max(prev[1], ih[1]))
    return {ch: halo.get(ch, (0, 0)) for ch in graph.graph_inputs}


def _clone_with_height(graph: DataflowGraph, new_h: int) -> DataflowGraph:
    """Rebuild ``graph`` with every plane's height replaced by ``new_h``.

    Stage bodies are shape-polymorphic, so the clone is pure metadata
    surgery; topology, names, windows and timing survive unchanged.
    """
    g2 = DataflowGraph(graph.name)
    cmap: dict[Channel, Channel] = {}
    for ch in graph.channels:
        c2 = g2.channel((new_h, ch.shape[1]), ch.dtype, name=ch.name)
        c2.is_graph_input = ch.is_graph_input
        c2.is_graph_output = ch.is_graph_output
        c2.depth = ch.depth
        cmap[ch] = c2
    for st in graph.stages:
        g2.task(st.name, st.kind, st.fn,
                [cmap[c] for c in st.inputs], [cmap[c] for c in st.outputs],
                window=st.window, ii=st.ii, fill=st.fill, meta=dict(st.meta))
    return g2


def _on(dev: torch.device):
    """Make ``dev`` current for a replica's launches (a no-op off the
    card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclasses.dataclass
class ReplicatedApp:
    """A dataflow app replicated across a 1-D device mesh.

    Call it like the :class:`~repro_torch.core.host.CompiledApp` it
    wraps — same input/output names, global plane shapes — and the row
    shards run one pipeline replica per mesh device.
    """

    schedule: Schedule                  # for the local extended plane
    mesh: ReplicaMesh
    n_replicas: int
    halo_rows: int
    plane: tuple[int, int]              # global (H, W)
    fn: Callable                        # (*inputs) -> tuple(outputs)
    input_names: list[str]
    output_names: list[str]
    #: the generated group kernels of every edge variant (one build per
    #: source: the variants differ only in ``valid_rows``)
    kernels: list = dataclasses.field(default_factory=list)

    def __call__(self, **inputs: Any) -> dict[str, torch.Tensor]:
        outs = self.fn(*[inputs[n] for n in self.input_names])
        return dict(zip(self.output_names, outs))

    def launch(self, **inputs: Any) -> LaunchHandle:
        """Enqueue every replica's launches and return at once; the
        handle's event follows the last replica's rows into the global
        outputs."""
        outs = self(**inputs)
        event = None
        dev = self.mesh.devices[0]
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return LaunchHandle(outs, event)

    def describe(self) -> str:
        devs = ", ".join(map(str, self.mesh.devices))
        lines = [f"replicated app {self.schedule.graph.name!r}: "
                 f"{self.n_replicas} replicas over mesh axis "
                 f"{self.mesh.axis_names[0]!r} ({devs})",
                 f"  global plane {self.plane} -> local "
                 f"({self.plane[0] // self.n_replicas}"
                 f"+2*{self.halo_rows} halo rows, {self.plane[1]})"]
        lines.append(self.schedule.describe())
        return "\n".join(lines)


def replicate_app(source: DataflowGraph | CompiledApp,
                  n_replicas: int | None = None, *,
                  backend=None, axis: str = "replica",
                  devices: list | None = None,
                  **compile_kwargs: Any) -> ReplicatedApp:
    """Replicate a dataflow app across devices by row-partitioning.

    ``source`` is a graph or an already-compiled app (its
    post-canonicalization graph, backend and device are reused).
    ``devices`` lists the replicas' devices and may name one device
    several times; by default the mesh is
    :func:`~repro_torch.parallel.sharding.replica_mesh` on the compiled
    app's device type (the card for a graph).  ``n_replicas`` defaults
    to every device of the mesh.

    Requirements: every channel in the graph is a 2-D plane of one
    shape, no stage is opaque (``custom``/``reduce``), the plane height
    divides evenly by the replica count and the cumulative halo fits a
    shard.

    ``tune="auto"`` (with optional ``tune_cache=``) tunes the *local
    extended* plane each replica runs, on the mesh's first device; the
    provenance shows up in ``rapp.describe()``.
    """
    known, sched_names, lower_names = replication_kwarg_routing()
    unknown = set(compile_kwargs) - known
    if unknown:
        raise TypeError(f"replicate_app got unsupported compile kwargs "
                        f"{sorted(unknown)}; supported: {sorted(known)}")
    if isinstance(source, CompiledApp):
        graph = source.schedule.graph
        backend = resolve(backend or source.backend)
        home = source.device
    else:
        graph = source
        backend = resolve(backend or "cuda_stream")
        home = None
    backend.require("replication")

    shapes = {ch.shape for ch in graph.channels}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise GraphError(
            f"replication row-partitions one 2-D plane; graph "
            f"{graph.name!r} has channel shapes {sorted(shapes)}")
    nonlocal_stages = [s.name for s in graph.stages
                       if s.kind in ("custom", "reduce")]
    if nonlocal_stages:
        raise GraphError(
            f"replication needs local (point/stencil/split) operators "
            f"with a known halo; stages {nonlocal_stages} are opaque "
            f"and could read across the row cut")
    H, W = next(iter(shapes))

    mesh = replica_mesh(n_replicas, axis=axis, devices=devices, device=home)
    k = mesh.size
    if H % k != 0:
        raise GraphError(
            f"plane height {H} does not divide over {k} replicas; "
            f"pick a replica count dividing H or pad the plane")
    h_local = H // k
    dev0 = mesh.devices[0]

    halos = graph_input_halo(graph)
    hy = max((h[0] for h in halos.values()), default=0)
    if hy >= h_local:
        raise GraphError(
            f"cumulative stencil halo ({hy} rows) does not fit a "
            f"{h_local}-row shard; use fewer replicas")

    # calibration resolves once, up front: the tuner's prior, the
    # scheduler's budgets and every replica's lowering all see the same
    # (possibly fitted) constants
    from repro_torch.tune.store import detect_device_kind
    backend = resolve_calibrated(backend, compile_kwargs.get("calibrate"),
                                 device_kind=detect_device_kind(dev0))
    sched_kwargs = {kw: v for kw, v in compile_kwargs.items()
                    if kw in sched_names}
    lower_kwargs = {kw: v for kw, v in compile_kwargs.items()
                    if kw in lower_names}
    spec = compile_kwargs.get("spec") or backend.spec or device_spec(dev0)
    sched_kwargs["spec"] = spec

    he = h_local + 2 * hy
    clone = _clone_with_height(graph, he)
    tune = compile_kwargs.get("tune")
    if tune == "model":
        tune = None
    notes: list[str] = []
    if tune is not None:
        # tune the *local extended* plane: that is the graph each
        # replica runs, and its TuningCache entry is keyed by the
        # extended shape
        if compile_kwargs.get("vector_factor") is not None:
            raise TypeError("tune= and vector_factor= are mutually "
                            "exclusive in replicate_app")
        if compile_kwargs.get("max_tile") is not None:
            raise TypeError("tune= and max_tile= are mutually exclusive "
                            "in replicate_app: the tile cap is one of "
                            "the tuner's search axes")
        from repro_torch.tune.search import (resolve_tuning,
                                             tuned_schedule_kwargs)
        tuned = resolve_tuning(
            clone, backend, tune=tune, spec=spec,
            cache=compile_kwargs.get("tune_cache"), device=dev0,
            strict=compile_kwargs.get("strict", False),
            canonicalize=compile_kwargs.get("canonicalize", True),
            passes=compile_kwargs.get("passes"))
        if tuned is not None:
            config, tile_source, notes = tuned
            sched_kwargs.update(
                tuned_schedule_kwargs(config, tile_source, spec))
    sched = build_schedule(clone, **sched_kwargs)
    sched.diagnostics.extend(notes)

    def variant(valid_rows: tuple[int, int]) -> Callable:
        # per-stage zero masking must follow the *global* image edges: a
        # shard at the top/bottom owns halo rows that lie outside the
        # image, and intermediates there are zero in the single-device
        # semantics.  One lowering per edge kind, same schedule/tiles.
        run, _ = lower_graph(sched.graph, backend, schedule=sched,
                             valid_rows=valid_rows, **lower_kwargs)
        return run

    if k == 1:
        runs = [variant((hy, hy + h_local))]
    else:
        top, bottom = variant((hy, he)), variant((0, hy + h_local))
        middle = variant((0, he)) if k > 2 else None
        runs = [top, *[middle] * (k - 2), bottom]
    kernels = [kn for run in dict.fromkeys(runs) for kn in run.kernels]

    ins = list(graph.graph_inputs)
    input_names = [c.name for c in ins]
    output_names = [c.name for c in graph.graph_outputs]
    devs = mesh.devices

    def fn(*xs: Any) -> tuple[torch.Tensor, ...]:
        shards = []
        for ch, x in zip(ins, xs, strict=True):
            x = torch.as_tensor(x, dtype=as_dtype(ch.dtype))
            if tuple(x.shape) != (H, W):
                raise GraphError(f"input {ch.name!r}: expected shape "
                                 f"{(H, W)}, got {tuple(x.shape)}")
            x = x.contiguous()
            shards.append(halo_exchange_rows(
                [x[j * h_local:(j + 1) * h_local].to(devs[j],
                                                     non_blocking=True)
                 for j in range(k)], hy))
        # launch every replica before gathering any, so replicas on
        # different cards run side by side
        results = []
        for j in range(k):
            with _on(devs[j]):
                results.append(runs[j](
                    {n: s[j] for n, s in zip(input_names, shards)}))
        outs = []
        for n in output_names:
            first = results[0][n]
            out = torch.empty((H, W), dtype=first.dtype, device=devs[0])
            for j, res in enumerate(results):
                out[j * h_local:(j + 1) * h_local].copy_(
                    res[n][hy:hy + h_local])
            outs.append(out)
        return tuple(outs)

    return ReplicatedApp(schedule=sched, mesh=mesh, n_replicas=k,
                         halo_rows=hy, plane=(H, W), fn=fn,
                         input_names=input_names, output_names=output_names,
                         kernels=kernels)
