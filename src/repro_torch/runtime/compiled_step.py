"""One step function captured once as a CUDA graph and replayed.

:class:`CompiledStep` is the port's counterpart of ``jax.jit`` on a
serving step: the reference compiles its decode step once per batcher
(``src/repro/runtime/batcher.py:65``, ``jax.jit(self._decode_step)``)
and its launcher jits the step with the cache donated
(``src/repro/launch/serve.py:60-62``).  There is no reference module of
this name.

On the card a step is then one graph launch instead of one launch per
op from Python.  A call copies its inputs into static buffers (on the
current stream, ``non_blocking``, so a pinned host tensor's copy is
asynchronous) and then:

1. the first call runs the step eagerly on a side stream.  That is
   real work for this step, and it is the warm-up: the kernels'
   libraries load, their shared-memory opt-ins run once, cuBLAS sets
   up its workspace for the stream;
2. the second call captures the step on that stream (a capture executes
   nothing) and replays the graph for this step;
3. every later call replays it.

Nothing warms up by running the step an extra time, so a step whose
state update is not idempotent (the SSM's) still runs once a call.  The
capture uses ``capture_error_mode="thread_local"``: an unsafe CUDA call
from this thread (a host read such as ``.item()``, a pageable copy)
fails the capture, while other threads of the process may go on
working; Python's cycle collector is off while it runs, so no dead
object is freed inside it.  A failed capture or replay raises, and the
step stays broken; nothing falls back to the eager step on the card.

What the step function may do: take its inputs as positional tensors,
close over tensors that keep their addresses for the step's life (the
parameters, a cache updated in place), and return a tensor or a tuple
of tensors.  Outputs are returned as copies, as the reference returns
fresh arrays, so a result stays put when the next step replays.

On the CPU the step runs eagerly at every call, with the same static
buffers and copies: that is the CPU path, not a fallback.

Tracing (:mod:`repro_torch.obs.tracer`, the process-global tracer): a
call is one span, ``compiled.warm_up``, ``compiled.capture`` (then
``compiled.replay``), ``compiled.replay``, or on the CPU
``compiled.eager``.  No span opens inside the step function: that code
runs once, at the capture.

Launch counts: the kernel wrappers count a launch when their Python
runs.  A capture runs that Python once and a replay runs none of it, so
the counters' delta over the capture is the step's launches; it is taken
back after the capture and added once for each executed step.  (Another
thread's counted launches during the capture would be taken back too.)
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.tracer import maybe_span, resolve_tracer

__all__ = ["CompiledStep", "launch_counters"]


def launch_counters() -> tuple:
    """The LM kernel wrappers, each of which counts its launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.kernels.moe_experts import moe_experts
    from repro_torch.kernels.ssd_scan import ssd_scan
    return (decode_attention, flash_attention, fused_mlp, moe_experts,
            ssd_scan)


def _count_names(fn) -> list[str]:
    """The counter attributes of wrapper ``fn``: ``launches`` and each
    route's ``<route>_launches``."""
    return sorted(k for k, v in vars(fn).items()
                  if k.endswith("launches") and isinstance(v, int))


def _copies(out):
    """Copies of a step's outputs (a tensor or a tuple of tensors)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) for t in outs):
        raise TypeError("a compiled step must return a tensor or a tuple "
                        "of tensors")
    copies = tuple(t.clone() for t in outs)
    return copies if isinstance(out, tuple) else copies[0]


class CompiledStep:
    """``step = CompiledStep(fn, device)``; ``step(*inputs)`` returns
    what ``fn(*inputs)`` returns, as copies.

    ``counters``: the wrappers whose launch counts the step keeps exact
    (default :func:`launch_counters`).  After a call: ``steps`` executed
    steps, ``captures`` (0 or 1), ``capture_ms`` (host ms of the
    capture) and ``step_launches`` (``name`` or ``name.route`` ->
    launches a step, from the capture).  ``tracer``: the process-global
    tracer at construction, if any.
    """

    def __init__(self, fn: Callable, device=None,
                 counters: Sequence | None = None):
        self.fn = fn
        self.device = resolve_device(device)
        self.tracer = resolve_tracer(None)
        self.counters = tuple(launch_counters() if counters is None
                              else counters)
        self.graphed = self.device.type == "cuda"
        self.steps = 0
        self.captures = 0
        self.capture_ms: float | None = None
        self.step_launches: dict[str, int] = {}
        self._signature = None
        self._inputs: tuple = ()
        self._graph = None
        self._outputs = None
        self._stream = None
        self._delta: list[tuple[Callable, str, int]] = []
        self._broken: str | None = None

    # ------------------------------------------------------------------
    def __call__(self, *inputs: torch.Tensor):
        self._stage(inputs)
        tr = self.tracer
        if not self.graphed:
            with maybe_span(tr, "compiled.eager", cat="compiled"):
                out = _copies(self.fn(*self._inputs))
        elif self.steps == 0:
            with maybe_span(tr, "compiled.warm_up", cat="compiled"):
                out = self._warm_up()
        else:
            if self._graph is None:
                with maybe_span(tr, "compiled.capture", cat="compiled"):
                    self._capture()
            with maybe_span(tr, "compiled.replay", cat="compiled"):
                self._replay()
            out = _copies(self._outputs)
        self.steps += 1
        return out

    def _stage(self, inputs) -> None:
        """Checks the call against the first one and copies the inputs
        into the static buffers."""
        if self._broken is not None:
            raise RuntimeError(f"compiled step unusable: {self._broken}")
        sig = tuple((tuple(x.shape), x.dtype, x.device) for x in inputs)
        if self._signature is None:
            self._signature = sig
            self._inputs = tuple(torch.empty(s, dtype=d, device=self.device)
                                 for s, d, _ in sig)
        elif sig != self._signature:
            raise ValueError(f"compiled step called with inputs {sig}; it "
                             f"was compiled for {self._signature}")
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(x, non_blocking=True)

    def _warm_up(self):
        """The first step, eagerly, on the stream the capture will use."""
        current = torch.cuda.current_stream(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self.fn(*self._inputs)
        current.wait_stream(self._stream)
        out = _copies(out)
        # the step's temporaries were allocated on the side stream: let
        # it finish before they are reused
        torch.cuda.synchronize(self.device)
        return out

    def _capture(self) -> None:
        before = [(fn, name, getattr(fn, name)) for fn in self.counters
                  for name in _count_names(fn)]
        self._broken = "its capture failed"
        t0 = time.perf_counter()
        try:
            graph, out = self._record()
        finally:            # the capture launched nothing: count nothing
            delta = [(fn, name, getattr(fn, name) - n0)
                     for fn, name, n0 in before]
            for fn, name, n0 in before:
                setattr(fn, name, n0)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self._outputs = out
        self._graph = graph
        self._delta = [d for d in delta if d[2]]
        self.step_launches = {
            fn.__name__ + ("" if name == "launches"
                           else "." + name[:-len("_launches")]): n
            for fn, name, n in self._delta}
        self.captures += 1
        self._broken = None

    def _record(self):
        """Captures the step on the warm-up's stream: (graph, outputs).
        Python's cycle collector runs just before and is off during the
        capture: a dead cycle holding CUDA objects (another step's graph,
        pinned staging) freed inside the capture would invalidate it."""
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self.fn(*self._inputs)
        finally:
            if was_enabled:
                gc.enable()
        return graph, out

    def _replay(self) -> None:
        self._broken = "a replay failed"
        self._graph.replay()
        self._broken = None
        for fn, name, n in self._delta:
            setattr(fn, name, getattr(fn, name) + n)
