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
too).  ``replicas`` other than 1 raise
:class:`~repro_torch.device.NotPortedError` (replication is
``ROADMAP.md`` A6).
"""
from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.graph import as_dtype
from repro_torch.core.host import CompiledApp
from repro_torch.device import NotPortedError
from repro_torch.obs.tracer import resolve_tracer

__all__ = ["MicroBatcher"]


class _Rotation:
    """One set of pinned staging buffers, one per graph input."""

    __slots__ = ("tensors", "arrays", "copied")

    def __init__(self, app: CompiledApp, width: int, pin: bool):
        self.tensors = [torch.zeros((width, *ch.shape),
                                    dtype=as_dtype(ch.dtype), pin_memory=pin)
                        for ch in app.graph.graph_inputs]
        #: numpy views of the same memory: a row is staged in one memcpy
        self.arrays = [t.numpy() for t in self.tensors]
        #: recorded after the copy to the card that read this rotation
        self.copied: Any = None


class MicroBatcher:
    """Stacks same-signature requests and launches one batched app.

    ``launch`` is asynchronous on the card: it returns the stacked
    device outputs as soon as the copies and kernels are enqueued, so
    the engine can keep further batches in flight (slot-pool
    pipelining) before reading the first back to the host.
    """

    def __init__(self, max_batch: int = 8, donate: bool = True,
                 replicas: int = 1, staging_depth: int = 2,
                 trace: Any = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if replicas != 1:
            raise NotPortedError(
                f"replicas={replicas}: replication across cards is not "
                f"ported to repro_torch yet (ROADMAP.md A6)")
        if staging_depth < 1:
            raise ValueError(
                f"staging_depth must be >= 1, got {staging_depth}")
        self.max_batch = max_batch
        #: accepted for the reference's signature; no effect (module doc)
        self.donate = donate
        #: how many launches of one (sig, width) bucket get distinct
        #: staging buffers before the first is rewritten; keep it
        #: STRICTLY greater than the number of unretired launches
        self.staging_depth = staging_depth
        #: pinned staging buffers: (sig, width) -> staging_depth rotations
        self._staging: dict[tuple[str, int], list[_Rotation]] = {}
        self._staging_clock: dict[tuple[str, int], int] = {}
        #: width -> number of launches that used that bucket
        self.bucket_launches: dict[int, int] = {}
        #: flight recorder for per-bucket stack/launch spans (None =
        #: untraced; ``False`` opts out even of the global tracer)
        self.tracer = resolve_tracer(trace) if trace is not False else None

    # ------------------------------------------------------------------
    # bucketed pad widths
    # ------------------------------------------------------------------
    def bucket(self, n: int) -> int:
        """Padded width for an ``n``-request batch: the next power of
        two >= ``n``, capped at ``max_batch``."""
        if n < 1:
            raise ValueError(f"bucket width needs n >= 1, got {n}")
        w = 1
        while w < n:
            w <<= 1
        return min(w, self.max_batch)

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
        if rot.copied is not None:
            rot.copied.synchronize()
            rot.copied = None
        return rot

    def _stage(self, app: CompiledApp, requests: Sequence[Any],
               pad_to: int | None, check_shapes: bool) -> _Rotation:
        if not requests:
            raise ValueError(
                "cannot stack an empty request batch (engine shutdown "
                "race?); callers must skip empty batches")
        width = max(pad_to or 0, self.bucket(len(requests)), len(requests))
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
               check_shapes: bool = True) -> dict[str, torch.Tensor]:
        """Stage, copy to the app's device and run one batch; return
        the stacked outputs without waiting for them.

        ``requests`` need only expose ``.inputs`` (a name->array dict);
        they must all share ``app``'s signature.  The batch is padded
        to its power-of-two bucket (or ``pad_to``); output rows beyond
        ``len(requests)`` are padding and must be ignored by the
        caller.  ``timings``, when given, receives the host-side
        ``stack`` (staging copy) and ``launch`` (enqueueing the copies
        to the card and the kernels) phase durations in seconds.
        """
        if len(requests) > self.max_batch:
            raise ValueError(
                f"batch of {len(requests)} exceeds max_batch={self.max_batch}")
        t0 = time.perf_counter()
        rot = self._stage(app, requests, pad_to, check_shapes)
        width = rot.tensors[0].shape[0]
        t1 = time.perf_counter()
        dev = app.device
        if dev.type == "cuda":
            args = [t.to(dev, non_blocking=True) for t in rot.tensors]
            rot.copied = torch.cuda.Event()
            rot.copied.record(torch.cuda.current_stream(dev))
        else:
            args = rot.tensors
        outs = app.batch_fn(*args)
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
        return dict(zip(app.output_names, outs))
