"""Micro-batching: stack same-signature requests, one launch per group.

Port of :mod:`repro.runtime.batching`.  Per-request dispatch pays the
host-side launch overhead once per item; a serving engine under load
amortizes it by stacking requests whose apps share a
:meth:`~repro_torch.core.host.CompiledApp.signature` along a new
leading axis and running the app's batched entry
(:attr:`~repro_torch.core.host.CompiledApp.batch_fn`): each fusion
group's kernel launches once for the whole batch (``gridDim.z = B``),
the port of the reference's ``jax.jit(jax.vmap(app.fn))``.

Two host-side overheads are engineered out of the hot path, as in the
reference:

- **bucketed pad shapes** — ``launch`` pads to the next power-of-two
  *bucket* (capped at ``max_batch``), so a 2-request batch launches a
  2-frame kernel, not a ``max_batch``-frame one; ``bucket_launches``
  records which buckets actually ran.
- **zero-copy staging** — request rows are written directly into
  *pinned* per-bucket host buffers (allocated at a bucket's first use,
  rotated ``staging_depth`` deep) instead of a fresh host array per
  batch: one ``memcpy`` per row, no per-batch allocation.  The copy to
  the card is ``non_blocking`` on the current stream, so it reads the
  pinned buffer *after* ``launch`` returns: a rotation may be rewritten
  only once the batch that used it has been retired.  The engine keeps
  ``staging_depth = inflight + 1`` for that; each rotation also
  remembers an event recorded after its copy, and re-staging into it
  waits on that event, which costs nothing when the depth is right.

Apps on the CPU run their batched entry on the staging buffers
directly (the ``torch`` backends and every CPU plain version write new
outputs).  ``donate=`` is accepted and has no effect: every launch
allocates its outputs (the reference resolves donation away on the CPU
too).

``replicas=k`` is the batch-parallel farm: the padded width rounds up
to a multiple of k, and replica r copies rows ``[r*B/k, (r+1)*B/k)``
of the batch to its own device (``devices[r]``, which may repeat a
device) and launches the batched entry on them (``gridDim.z = B/k``),
all copies first, then all launches, so replicas on different cards
run side by side.  Replica r's staging is its own row slice of each
pinned rotation.  Its outputs stay on its device: ``launch`` then
returns, per output, the list of the k replicas' row slices.

A :class:`BatchSpan` passed to ``launch`` receives the device time of
the batch's launches alone (no staging, copy or readback).  On the
card, each device's stream gets a
:class:`~repro_torch.kernels.launch_gate.LaunchGate` behind the
batch's copies, then a pair of timing events around the batch's
launches; the gate lets the stream through once the host has queued the
last launch, so the pair holds neither the host's work nor the card's
launch latency.  On the CPU it is the host clock around the batched
entry.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.graph import as_dtype
from repro_torch.core.host import CompiledApp
from repro_torch.kernels.launch_gate import LaunchGate
from repro_torch.obs.tracer import resolve_tracer
from repro_torch.parallel.sharding import ReplicaMesh, replica_mesh

__all__ = ["MicroBatcher", "BatchSpan"]


class BatchSpan:
    """The device time of one batch's launches.

    On the card, ``marks`` holds ``(gate, ticket, start, end)`` per
    device: the device's launch gate and ticket, and the timing events
    around the batch's launches on it (module doc).  Replicas on one
    device run one after another inside its pair; replicas on several
    cards run side by side, and :meth:`seconds` is the busiest device's
    pair.  On the CPU, ``host_s`` is the host time around the batched
    entry.  ``items`` is the most frames one device computed.
    """

    __slots__ = ("marks", "host_s", "items")

    def __init__(self):
        self.marks: list = []
        self.host_s = 0.0
        self.items = 0

    def seconds(self) -> float | None:
        """Seconds of device time (waits for the launches to finish);
        None when a gate timed out, and its pair held the host's work."""
        if not self.marks:
            return self.host_s
        busy = []
        for gate, ticket, start, end in self.marks:
            end.synchronize()
            if gate.late(ticket):
                return None
            busy.append(start.elapsed_time(end) * 1e-3)
        return max(busy)


class _Rotation:
    """One set of pinned staging buffers, one per graph input."""

    __slots__ = ("tensors", "arrays", "copied")

    def __init__(self, app: CompiledApp, width: int, pin: bool):
        self.tensors = [torch.zeros((width, *ch.shape),
                                    dtype=as_dtype(ch.dtype), pin_memory=pin)
                        for ch in app.graph.graph_inputs]
        #: numpy views of the same memory: a row is staged in one memcpy
        self.arrays = [t.numpy() for t in self.tensors]
        #: recorded after each replica's copy to the card that read this
        #: rotation (empty off the card)
        self.copied: list = []


class MicroBatcher:
    """Stacks same-signature requests and launches one batched app.

    ``launch`` is asynchronous on the card: it returns the stacked
    device outputs as soon as the copies and kernels are enqueued, so
    the engine can keep further batches in flight (slot-pool
    pipelining) before reading the first back to the host.
    """

    def __init__(self, max_batch: int = 8, donate: bool = True,
                 replicas: int = 1, replica_axis: str = "replica",
                 devices: Sequence[Any] | None = None,
                 staging_depth: int = 2, trace: Any = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_batch % replicas != 0:
            raise ValueError(
                f"max_batch={max_batch} must divide evenly over "
                f"replicas={replicas}: every replica serves "
                f"max_batch/replicas rows of the padded batch")
        if staging_depth < 1:
            raise ValueError(
                f"staging_depth must be >= 1, got {staging_depth}")
        self.max_batch = max_batch
        #: accepted for the reference's signature; no effect (module doc)
        self.donate = donate
        self.replicas = replicas
        self.replica_axis = replica_axis
        #: the replicas' devices; without ``devices=`` a farm's mesh is
        #: resolved on the first app's device type (``replica_mesh``),
        #: and one replica runs on each app's own device
        self._mesh: ReplicaMesh | None = (
            replica_mesh(replicas, axis=replica_axis, devices=devices)
            if devices is not None else None)
        #: how many launches of one (sig, width) bucket get distinct
        #: staging buffers before the first is rewritten; keep it
        #: STRICTLY greater than the number of unretired launches
        self.staging_depth = staging_depth
        #: pinned staging buffers: (sig, width) -> staging_depth rotations
        self._staging: dict[tuple[str, int], list[_Rotation]] = {}
        self._staging_clock: dict[tuple[str, int], int] = {}
        #: width -> number of launches that used that bucket
        self.bucket_launches: dict[int, int] = {}
        #: each card's launch gate (only a BatchSpan uses them)
        self._gates: dict[torch.device, LaunchGate] = {}
        #: flight recorder for per-bucket stack/launch spans (None =
        #: untraced; ``False`` opts out even of the global tracer)
        self.tracer = resolve_tracer(trace) if trace is not False else None

    # ------------------------------------------------------------------
    # bucketed pad widths
    # ------------------------------------------------------------------
    def bucket(self, n: int) -> int:
        """Padded width for an ``n``-request batch: the next power of
        two >= ``n``, rounded up to a multiple of the replica count and
        capped at ``max_batch``."""
        if n < 1:
            raise ValueError(f"bucket width needs n >= 1, got {n}")
        w = 1
        while w < n:
            w <<= 1
        w = -(-w // self.replicas) * self.replicas
        return min(w, self.max_batch)

    def _replica_devices(self, app: CompiledApp) -> tuple[torch.device, ...]:
        """The device each replica runs ``app``'s batches on."""
        if self._mesh is None:
            if self.replicas == 1:
                return (app.device,)
            self._mesh = replica_mesh(self.replicas, axis=self.replica_axis,
                                      device=app.device)
        devs = self._mesh.devices
        if devs[0].type != app.device.type:
            raise ValueError(f"app {app.graph.name!r} is compiled for "
                             f"{app.device}; the replicas run on "
                             f"{devs[0].type}")
        return devs

    def _open_span(self, dev: torch.device) -> tuple:
        """Hold ``dev``'s stream at its gate and record the start of a
        batch's pair behind it."""
        gate = self._gates.get(dev)
        if gate is None:
            gate = self._gates[dev] = LaunchGate(dev)
        ticket = gate.hold()
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        return gate, ticket, start

    # ------------------------------------------------------------------
    # zero-copy staging
    # ------------------------------------------------------------------
    def _rotation(self, app: CompiledApp, width: int) -> _Rotation:
        """The next rotation of pinned staging buffers for one bucket,
        free to rewrite (its last copy to the card has finished)."""
        key = (app.signature(), width)
        rotations = self._staging.get(key)
        if rotations is None:
            pin = app.device.type == "cuda"
            rotations = [_Rotation(app, width, pin)
                         for _ in range(self.staging_depth)]
            self._staging[key] = rotations
            self._staging_clock[key] = 0
        clock = self._staging_clock[key]
        self._staging_clock[key] = clock + 1
        rot = rotations[clock % self.staging_depth]
        for event in rot.copied:
            event.synchronize()
        rot.copied = []
        return rot

    def _stage(self, app: CompiledApp, requests: Sequence[Any],
               pad_to: int | None, check_shapes: bool) -> _Rotation:
        if not requests:
            raise ValueError(
                "cannot stack an empty request batch (engine shutdown "
                "race?); callers must skip empty batches")
        width = max(pad_to or 0, self.bucket(len(requests)), len(requests))
        width = -(-width // self.replicas) * self.replicas
        rot = self._rotation(app, width)
        for ch, buf in zip(app.graph.graph_inputs, rot.arrays):
            name = ch.name
            if check_shapes:
                shape = tuple(ch.shape)
                for idx, r in enumerate(requests):
                    row = np.asarray(r.inputs[name])
                    if row.shape != shape:
                        raise ValueError(
                            f"request[{idx}] input {name!r}: expected "
                            f"shape {shape}, got {row.shape}")
                    buf[idx, ...] = row
            else:
                # engine path: rows were shape-checked at submit();
                # numpy's row assignment casts + copies in one shot
                for idx, r in enumerate(requests):
                    buf[idx, ...] = r.inputs[name]
        return rot

    def stack(self, app: CompiledApp, requests: Sequence[Any],
              pad_to: int | None = None,
              check_shapes: bool = True) -> list[torch.Tensor]:
        """Write each request's inputs into the pinned staging buffers.

        Rows land directly in a preallocated ``(width, *shape)`` host
        buffer (one memcpy per row); rows beyond ``len(requests)`` keep
        whatever the previous batch staged (padding rows are computed
        but never read back).  ``pad_to`` forces a width; by default the
        power-of-two :meth:`bucket` is used.  The returned buffers stay
        valid until ``staging_depth`` more batches of the same
        (signature, width) are staged.  Request inputs are host arrays
        (numpy, or CPU tensors); shapes are checked per request unless
        ``check_shapes=False``.
        """
        return self._stage(app, requests, pad_to, check_shapes).tensors

    def launch(self, app: CompiledApp, requests: Sequence[Any],
               pad_to: int | None = None,
               timings: dict[str, float] | None = None,
               check_shapes: bool = True,
               span: BatchSpan | None = None) -> dict[str, Any]:
        """Stage, copy to the app's device and run one batch; return
        the stacked outputs without waiting for them.

        ``requests`` need only expose ``.inputs`` (a name->array dict);
        they must all share ``app``'s signature.  The batch is padded
        to its power-of-two bucket (or ``pad_to``); output rows beyond
        ``len(requests)`` are padding and must be ignored by the
        caller.  With replicas, each output is the list of the
        replicas' row slices, in row order (module doc).  ``timings``,
        when given, receives the host-side ``stack`` (staging copy) and
        ``launch`` (enqueueing the copies to the card and the kernels)
        phase durations in seconds; ``span`` the device time of the
        launches (:class:`BatchSpan`).
        """
        if len(requests) > self.max_batch:
            raise ValueError(
                f"batch of {len(requests)} exceeds max_batch={self.max_batch}")
        if app.batch_fn is None:
            raise ValueError(f"app {app.graph.name!r} has no batched entry "
                             f"(an app compiled with a mesh runs one frame "
                             f"a call)")
        devs = self._replica_devices(app)
        t0 = time.perf_counter()
        rot = self._stage(app, requests, pad_to, check_shapes)
        width = rot.tensors[0].shape[0]
        rows = width // len(devs)
        t1 = time.perf_counter()
        # every replica's copies first, then the launches, so replicas
        # on different cards overlap their copies with each other's work
        args = []
        for r, dev in enumerate(devs):
            part = [t[r * rows:(r + 1) * rows] for t in rot.tensors]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    part = [t.to(dev, non_blocking=True) for t in part]
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                rot.copied.append(event)
            args.append(part)
        outs = []
        opened: dict[torch.device, tuple] = {}   # device -> gate, ticket, start
        try:
            for dev, part in zip(devs, args):
                if dev.type != "cuda":
                    h0 = time.perf_counter()
                    outs.append(app.batch_fn(*part))
                    if span is not None:
                        span.host_s += time.perf_counter() - h0
                    continue
                with torch.cuda.device(dev):
                    if span is not None and dev not in opened:
                        opened[dev] = self._open_span(dev)
                    outs.append(app.batch_fn(*part))
            for dev, (gate, ticket, start) in opened.items():
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(dev))
                span.marks.append((gate, ticket, start, end))
        finally:
            for gate, ticket, _start in opened.values():
                gate.release(ticket)
        if span is not None:
            span.items = rows * max(collections.Counter(devs).values())
        t2 = time.perf_counter()
        self.bucket_launches[width] = self.bucket_launches.get(width, 0) + 1
        if timings is not None:
            timings["stack"] = t1 - t0
            timings["launch"] = t2 - t1
        if self.tracer is not None:
            # retroactive complete spans from the stamps above — the
            # recording itself adds nothing between stack and dispatch
            self.tracer.complete("batch.stack", t0, t1 - t0,
                                 cat="batcher", app=app.graph.name,
                                 width=width, rows=len(requests))
            self.tracer.complete("batch.launch", t1, t2 - t1,
                                 cat="batcher", app=app.graph.name,
                                 width=width)
        if len(devs) == 1:
            return dict(zip(app.output_names, outs[0]))
        return {n: [o[i] for o in outs]
                for i, n in enumerate(app.output_names)}
