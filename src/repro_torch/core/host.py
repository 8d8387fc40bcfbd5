"""Host-code generation (FLOWER contribution C4).

Port of :mod:`repro.core.host`.  :func:`build_host_app` derives the
launcher from the scheduled graph: input placement on the app's
device, the call into the lowered graph, and the buffer declarations
that :meth:`CompiledApp.host_program` renders as an XRT-style listing.

Differences from the reference: readiness of an asynchronous launch is
a CUDA event (``Event.query()``) instead of ``is_ready()``; buffer
donation is not ported (every call allocates new output tensors), and
meshes wait for the replication slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.graph import DataflowGraph, GraphError, as_dtype, dtype_name
from repro_torch.core.schedule import Schedule

__all__ = ["CompiledApp", "LaunchHandle", "build_host_app"]


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
            "auto device = xcl::get_devices()[0];",
            'auto bin = xcl::read_binary_file("%s.xclbin");' % self.graph.name,
            "auto q = cl::CommandQueue(context, device, 0);",
        ]
        for b in self.buffers:
            flag = "CL_MEM_READ_ONLY" if b.direction == "in" else "CL_MEM_WRITE_ONLY"
            nbytes = int(np.prod(b.shape)) * getattr(torch, b.dtype).itemsize
            lines.append(f"cl::Buffer {b.name}(context, {flag}, /*bytes=*/"
                         f"{nbytes}); // bundle=mem{b.bundle}")
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
                   device=None) -> CompiledApp:
    """Generate the host launcher around an already-lowered graph.

    ``run`` is the whole-graph function from
    :func:`repro_torch.core.fusion.lower_graph`; the graph is taken from
    the schedule so launcher and kernels never disagree on the I/O.
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

    buffers = [BufferDecl(c.name, c.shape, dtype_name(c.dtype), "in", c.bundle)
               for c in graph.graph_inputs]
    buffers += [BufferDecl(c.name, c.shape, dtype_name(c.dtype), "out",
                           c.bundle)
                for c in graph.graph_outputs]
    batched = getattr(run, "batched", None)
    return CompiledApp(graph, sched, backend, entry(run), buffers,
                       input_names, output_names, device,
                       list(getattr(run, "kernels", [])),
                       entry(batched) if batched is not None else None)
