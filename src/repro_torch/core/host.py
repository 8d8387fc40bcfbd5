"""Host-code generation (FLOWER contribution C4).

Port of :mod:`repro.core.host`.  :func:`build_host_app` derives the
launcher from the scheduled graph: input placement on the app's
device, the call into the lowered graph, and the buffer declarations
that :meth:`CompiledApp.host_program` renders as an XRT-style listing.

Differences from the reference: readiness of an asynchronous launch is
a CUDA event (``Event.query()``) instead of ``is_ready()``; donated
inputs are named in the buffer declarations but every call allocates
new output tensors; and an app compiled with a mesh runs through the
replicated launcher of :mod:`repro_torch.parallel.replicate`, where
the reference row-shards every plane under GSPMD.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataflowGraph, GraphError, as_dtype, dtype_name
from repro_torch.core.schedule import Schedule

__all__ = ["CompiledApp", "LaunchHandle", "build_host_app",
           "replicated_host_app"]


@dataclasses.dataclass
class LaunchHandle:
    """Future-like handle for one asynchronously enqueued execution.

    ``event`` is recorded on the current CUDA stream right after the
    launch (``None`` on the CPU, where the call has already finished).
    """

    outputs: dict[str, torch.Tensor]
    event: Any = None

    def done(self) -> bool:
        """True when the outputs have landed (non-blocking)."""
        return self.event is None or self.event.query()

    def result(self) -> dict[str, torch.Tensor]:
        """Block until the computation finishes; return the outputs."""
        if self.event is not None:
            self.event.synchronize()
        return self.outputs


@dataclasses.dataclass
class BufferDecl:
    name: str
    shape: tuple[int, ...]
    dtype: str
    direction: str        # "in" | "out"
    bundle: int | None
    #: named in ``compile_graph(donate=)``; no effect (module doc)
    donated: bool = False


@dataclasses.dataclass
class CompiledApp:
    """A fully-lowered dataflow application (device + generated host)."""

    graph: DataflowGraph
    schedule: Schedule
    #: the resolved :class:`~repro_torch.backends.Backend` record
    backend: Any
    fn: Callable                        # (*inputs) -> tuple(outputs)
    buffers: list[BufferDecl]
    input_names: list[str]
    output_names: list[str]
    device: torch.device
    #: the generated group kernels (``cuda_stream`` only)
    kernels: list = dataclasses.field(default_factory=list)
    #: ``fn`` over batches: every input and output has a leading axis of
    #: ``B`` frames; one kernel launch per group for all of them
    #: (:class:`~repro_torch.runtime.batching.MicroBatcher` calls it)
    batch_fn: Callable | None = None
    #: the :class:`~repro_torch.parallel.sharding.ReplicaMesh` of
    #: ``compile_graph(mesh=)``, and the
    #: :class:`~repro_torch.parallel.replicate.ReplicatedApp` that ``fn``
    #: runs then (``None`` for a single-device app)
    mesh: Any = None
    replicated: Any = None

    def _args(self, inputs: dict[str, Any]) -> list[torch.Tensor]:
        args = []
        for ch in self.graph.graph_inputs:
            if ch.name not in inputs:
                raise GraphError(f"missing graph input {ch.name!r}")
            x = torch.as_tensor(inputs[ch.name], dtype=as_dtype(ch.dtype),
                                device=self.device)
            if tuple(x.shape) != ch.shape:
                raise GraphError(f"input {ch.name!r}: expected shape "
                                 f"{ch.shape}, got {tuple(x.shape)}")
            args.append(x.contiguous())
        return args

    def __call__(self, **inputs: Any) -> dict[str, torch.Tensor]:
        return dict(zip(self.output_names, self.fn(*self._args(inputs))))

    def launch(self, **inputs: Any) -> LaunchHandle:
        """Enqueue one execution (the XRT ``enqueueTask``) and return at
        once with a :class:`LaunchHandle`."""
        outs = dict(zip(self.output_names, self.fn(*self._args(inputs))))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return LaunchHandle(outs, event)

    def signature(self) -> str:
        """Cache identity: canonical graph digest + backend cache key."""
        sig = getattr(self, "_signature", None)
        if sig is None:
            sig = f"{self.graph.signature()}:{self.backend.cache_key()}"
            self._signature = sig
        return sig

    def host_program(self) -> str:
        """Render the generated host code as an XRT-style listing."""
        lines = [
            "// ---- generated host program (XRT-style rendering) ----",
            f"// device: {self.device}",
        ]
        if self.replicated is not None:
            r = self.replicated
            local = (r.plane[0] // r.n_replicas + 2 * r.halo_rows, r.plane[1])
            lines.append(f"// mesh: {r.n_replicas} replicas over axis "
                         f"{r.mesh.axis_names[0]!r}, local plane {local} "
                         f"({r.halo_rows} halo rows a side)")
        lines += [
            "auto device = xcl::get_devices()[0];",
            'auto bin = xcl::read_binary_file("%s.xclbin");' % self.graph.name,
            "auto q = cl::CommandQueue(context, device, 0);",
        ]
        for b in self.buffers:
            flag = "CL_MEM_READ_ONLY" if b.direction == "in" else "CL_MEM_WRITE_ONLY"
            nbytes = int(np.prod(b.shape)) * getattr(torch, b.dtype).itemsize
            donated = " donated" if b.donated else ""
            lines.append(f"cl::Buffer {b.name}(context, {flag}, /*bytes=*/"
                         f"{nbytes}); // bundle=mem{b.bundle}{donated}")
        for b in self.buffers:
            if b.direction == "in":
                lines.append(f"q.enqueueWriteBuffer({b.name}, ...);  // H2D")
        for gi, g in enumerate(self.schedule.groups):
            names = ",".join(s.name for s in g.stages)
            vec = (f" tile={g.tile} vector_factor={g.vector_factor}"
                   if g.tile is not None else "")
            lines.append(f"launch kernel[{gi}]  "
                         f"// dataflow tasks: {names}{vec}")
        for b in self.buffers:
            if b.direction == "out":
                lines.append(f"q.enqueueReadBuffer({b.name}, ...);   // D2H")
        return "\n".join(lines)


def build_host_app(sched: Schedule, run: Callable, *, backend="cuda_stream",
                   device=None, donate: Sequence[str] = ()) -> CompiledApp:
    """Generate the host launcher around an already-lowered graph.

    ``run`` is the whole-graph function from
    :func:`repro_torch.core.fusion.lower_graph`; the graph is taken from
    the schedule so launcher and kernels never disagree on the I/O.
    ``donate`` names inputs whose buffers the caller gives up; a name
    that is not an input raises :class:`GraphError`.
    """
    from repro_torch.backends import resolve
    from repro_torch.device import resolve_device
    backend = resolve(backend)
    device = resolve_device(device)
    graph = sched.graph
    input_names = [c.name for c in graph.graph_inputs]
    output_names = [c.name for c in graph.graph_outputs]

    def entry(graph_run: Callable) -> Callable:
        def step(*args):
            outs = graph_run(dict(zip(input_names, args)))
            return tuple(outs[n] for n in output_names)
        return step

    batched = getattr(run, "batched", None)
    return CompiledApp(graph, sched, backend, entry(run),
                       _buffer_decls(graph, donate), input_names,
                       output_names, device,
                       list(getattr(run, "kernels", [])),
                       entry(batched) if batched is not None else None)


def replicated_host_app(graph: DataflowGraph, rep: Any, mesh: Any, *,
                        backend, device,
                        donate: Sequence[str] = ()) -> CompiledApp:
    """The host launcher of ``compile_graph(mesh=)``: the global
    plane's buffers around the launcher of ``rep``, a
    :class:`~repro_torch.parallel.replicate.ReplicatedApp`, whose
    schedule and kernels (the local extended plane's) are what runs.
    Such an app has no batched entry."""
    return CompiledApp(graph, rep.schedule, backend, rep.fn,
                       _buffer_decls(graph, donate), list(rep.input_names),
                       list(rep.output_names), device, list(rep.kernels),
                       None, mesh=mesh, replicated=rep)


def _buffer_decls(graph: DataflowGraph,
                  donate: Sequence[str]) -> list[BufferDecl]:
    """The graph's I/O buffers; ``donate`` must name inputs."""
    input_names = [c.name for c in graph.graph_inputs]
    unknown = sorted(set(donate) - set(input_names))
    if unknown:
        raise GraphError(f"donate names {unknown}, which are not inputs of "
                         f"{graph.name!r} (inputs: {input_names})")
    buffers = [BufferDecl(c.name, c.shape, dtype_name(c.dtype), "in", c.bundle,
                          c.name in donate)
               for c in graph.graph_inputs]
    buffers += [BufferDecl(c.name, c.shape, dtype_name(c.dtype), "out",
                           c.bundle)
                for c in graph.graph_outputs]
    return buffers
