"""Serving telemetry: measured metrics side-by-side with the Fig. 1 model.

Copy of :mod:`repro.runtime.telemetry`; the model side runs the
port's :mod:`repro_torch.core.simulate`.

The latency simulator (:mod:`repro_torch.core.simulate`) predicts what a
FIFO pipeline *should* do; a live engine measures what it *does*.
This module holds both ends: :class:`Telemetry` aggregates queue
depth, per-request latency percentiles, throughput and batch sizes
from a running :class:`~repro_torch.runtime.engine.StreamEngine`, and
:func:`modeled_latency` produces the matching analytic + simulated
predictions for the app being served, so every engine report shows
``measured`` next to ``modeled`` — the paper's performance model
validated against live traffic instead of a synthetic sweep.

Samples live in a :class:`~repro_torch.obs.metrics.MetricsRegistry` — one
:class:`~repro_torch.obs.metrics.Histogram` per sample stream (latency,
queue depth, batch size, one per hot-path phase) and one
:class:`~repro_torch.obs.metrics.Counter` per event count — instead of
private lists, so an operator can enumerate everything the engine
measures through the registry.  The histograms are **uniform
reservoirs** (deterministically seeded), not first-N buffers: a
multi-hour serving run's p99 reflects the whole run, where the old
first-``_MAX_SAMPLES`` truncation froze percentiles on whatever the
warm-up era looked like.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np

from repro_torch.core.simulate import TaskTiming, analytic_latency, simulate_pipeline
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["PHASES", "Telemetry", "modeled_latency"]

#: the submit→complete hot path, phase by phase: time spent queued
#: before being taken into a batch, waiting for the batch to form,
#: staging rows into the pinned batch buffers, dispatching the kernel,
#: and forcing outputs back to host memory
PHASES = ("queue_wait", "form", "stack", "launch", "readback")

#: reservoir capacity for each sample stream (latency, depths, ...)
_MAX_SAMPLES = 100_000

#: EWMA smoothing for the observed per-batch service time that drives
#: the engine's adaptive batch-formation budget
_SERVICE_ALPHA = 0.2

#: cap on items fed to the O(S*n) discrete simulator in reports
_SIM_ITEMS_CAP = 512


def modeled_latency(app: Any, n_items: int, depth: int = 2,
                    replicas: int = 1) -> dict[str, float]:
    """Fig. 1 predictions for serving ``n_items`` requests through ``app``.

    Tasks are the app's scheduled stages bracketed by the generated
    read/write (H2D/D2H) tasks, exactly as the fusion cost model
    scores them; ``depth`` is the FIFO depth of the engine's bounded
    queues.  Returns the closed-form ``sequential`` / ``dataflow``
    cycles plus the finite-depth discrete simulation
    (``dataflow_sim``), so backpressure effects are visible too.

    ``replicas > 1`` adds the batch-parallel-farm prediction: k
    identical pipelines each drain ``ceil(n/k)`` items, so the
    replicated latency is the dataflow latency of the per-replica
    share — linear scaling in the drain term (the farm's workers
    share no channels), with the fill paid once per replica in
    parallel.  ``replica_scaling_modeled`` is the predicted speedup of
    the farm over one replica.
    """
    tasks = ([TaskTiming("read", ii=1.0, fill=32.0)]
             + [TaskTiming(s.name, ii=s.ii, fill=s.fill)
                for s in app.schedule.order]
             + [TaskTiming("write", ii=1.0, fill=32.0)])
    n = max(1, n_items)
    out = dict(analytic_latency(tasks, n))
    sim = simulate_pipeline(tasks, min(n, _SIM_ITEMS_CAP),
                            depth=max(1, depth))
    out["dataflow_sim"] = sim["dataflow_sim"]
    if replicas > 1:
        per_replica = -(-n // replicas)
        out["dataflow_replicated"] = analytic_latency(
            tasks, per_replica)["dataflow"]
        out["replica_scaling_modeled"] = (out["dataflow"]
                                          / out["dataflow_replicated"])
    return out


class Telemetry:
    """Thread-safe metric aggregation for a serving engine.

    All samples and counters live in ``self.registry`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`, shareable across
    components); :class:`Telemetry` keeps only the EWMA state and the
    first/last completion stamps that throughput needs.  Metric names:
    ``latency_s``, ``queue_depth``, ``batch_size``, ``phase_<p>_s``
    (histograms) and ``submitted`` / ``completed`` / ``shed`` /
    ``cancelled`` (counters) — the same values the snapshot reports,
    queryable individually.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 max_samples: int = _MAX_SAMPLES, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else MetricsRegistry()
        reg, cap = self.registry, max_samples
        self._latency = reg.histogram("latency_s", cap, seed)
        self._queue_depth = reg.histogram("queue_depth", cap, seed)
        self._batch_size = reg.histogram("batch_size", cap, seed)
        self._phases = {p: reg.histogram(f"phase_{p}_s", cap, seed)
                        for p in PHASES}
        self._max_samples = cap
        self._seed = seed
        self._c_submitted = reg.counter("submitted")
        self._c_completed = reg.counter("completed")
        self._c_shed = reg.counter("shed")
        self._c_cancelled = reg.counter("cancelled")
        self._service_ewma_s: float | None = None
        self._t_first: float | None = None
        self._t_last: float | None = None
        #: device-farm width the served throughput is spread over;
        #: owned by the engine (it sets this to its ``replicas``) so
        #: reports show per-replica throughput next to the modeled
        #: linear scaling
        self.replicas = 1

    # -- counters (registry-backed, read like plain attributes) --------
    @property
    def submitted(self) -> int:
        return self._c_submitted.value

    @property
    def completed(self) -> int:
        return self._c_completed.value

    @property
    def shed(self) -> int:
        return self._c_shed.value

    @property
    def cancelled(self) -> int:
        return self._c_cancelled.value

    # -- observation hooks ---------------------------------------------
    def observe_submit(self, queue_depth: int) -> None:
        self._c_submitted.inc()
        self._queue_depth.observe(queue_depth)

    def observe_batch(self, size: int) -> None:
        self._batch_size.observe(size)

    def _phase(self, phase: str):
        h = self._phases.get(phase)
        if h is None:
            # double-checked under the lock: a snapshot() iterating
            # the phase table concurrently with the worker's flush
            # must never see the dict resize mid-iteration
            with self._lock:
                h = self._phases.get(phase)
                if h is None:
                    h = self._phases[phase] = self.registry.histogram(
                        f"phase_{phase}_s", self._max_samples, self._seed)
        return h

    def observe_phase(self, phase: str, seconds: float) -> None:
        """Record time spent in one hot-path phase (see :data:`PHASES`)."""
        self._phase(phase).observe(seconds)

    def observe_service(self, seconds: float) -> None:
        """Record one batch's dispatch→ready service time (EWMA'd).

        The engine adapts its batch-formation budget from this: a
        request should never wait longer for stragglers than a
        fraction of the time the batch will take to execute anyway.
        """
        with self._lock:
            prev = self._service_ewma_s
            self._service_ewma_s = (seconds if prev is None else
                                    _SERVICE_ALPHA * seconds
                                    + (1.0 - _SERVICE_ALPHA) * prev)

    def observe_batch_events(self, *, batch_size: int | None = None,
                             phases: dict[str, Any] | None = None,
                             completions: list[float] | None = None,
                             service_s: float | None = None) -> None:
        """Record one batch's worth of observations in one call.

        ``phases`` values may be a scalar duration or a list of
        per-request durations.  (Histograms carry their own fine-
        grained locks; the shared Telemetry lock only guards the EWMA
        and throughput stamps.)
        """
        self.observe_batches([(time.perf_counter(), batch_size, phases,
                               completions, service_s)])

    def observe_batches(self, entries: list) -> None:
        """Bulk-ingest buffered per-batch observations.

        Each entry is ``(t_observed, batch_size, phases, completions,
        service_s)``; ``t_observed`` preserves the original wall-clock
        of the observation so throughput spans stay correct under
        deferred flushing.
        """
        n_done = 0
        for now, batch_size, phases, completions, service_s in entries:
            if batch_size is not None:
                self._batch_size.observe(batch_size)
            if phases:
                for p, vals in phases.items():
                    h = self._phase(p)
                    if isinstance(vals, (int, float)):
                        h.observe(float(vals))
                    else:
                        h.extend(vals)
            if completions:
                n_done += len(completions)
                self._latency.extend(completions)
                with self._lock:
                    # min/max (not first/latest writer): two threads
                    # flushing out of order must not shrink the span
                    if self._t_first is None or now < self._t_first:
                        self._t_first = now
                    if self._t_last is None or now > self._t_last:
                        self._t_last = now
            if service_s is not None:
                self.observe_service(service_s)
        if n_done:
            self._c_completed.inc(n_done)

    def observe_submits(self, count: int, queue_depths: list[int]) -> None:
        """Bulk-ingest buffered submit observations."""
        self._c_submitted.inc(count)
        self._queue_depth.extend(queue_depths)

    def observe_shed(self) -> None:
        """One request rejected by admission control (QueueFullError)."""
        self._c_shed.inc()

    def observe_cancel(self) -> None:
        """One request abandoned by its caller before completion."""
        self._c_cancelled.inc()

    @property
    def service_ewma_s(self) -> float | None:
        """Smoothed per-batch service time, or None before any batch."""
        with self._lock:
            return self._service_ewma_s

    def observe_completion(self, latency_s: float) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
        self._c_completed.inc()
        self._latency.observe(latency_s)

    def reset(self) -> None:
        """Zero all samples and counters (keeps ``replicas``).

        Lets a benchmark or operator mark the start of a measurement
        window after warmup — compile latencies from first-launch
        bucket warming would otherwise dominate small-sample p99s.
        Reservoir RNGs are re-seeded, so the window replays
        deterministically.
        """
        self.registry.reset()
        with self._lock:
            self._service_ewma_s = None
            self._t_first = self._t_last = None

    # -- aggregation ---------------------------------------------------
    @staticmethod
    def _pct(xs: list[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def snapshot(self, *, flat: bool = False) -> dict[str, Any]:
        """Measured serving metrics so far (JSON-safe).

        Percentile keys from an **empty** latency reservoir come back
        ``None`` with ``latency_samples == 0`` — never an ``inf``/NaN
        that breaks a JSON consumer, and never a fake ``0.0`` that
        reads as a zero-latency engine.  Non-finite observations (a
        hung launch's clock) are filtered before every percentile.
        Safe to call from any thread, concurrently with the worker's
        bulk-ingest flush.  ``flat=True`` returns one level of dotted
        keys (``phases.launch.p99_ms``) for CSV/JSON sinks.
        """
        lat = self._latency.finite_samples()
        depths = self._queue_depth.finite_samples()
        sizes = self._batch_size.finite_samples()
        completed = self._c_completed.value
        with self._lock:
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None and completed > 1)
                    else 0.0)
            ewma = self._service_ewma_s
            phase_items = list(self._phases.items())
        tput = (completed - 1) / span if span else 0.0
        phases = {}
        for p, h in phase_items:
            xs = h.finite_samples()
            if xs:
                phases[p] = {"mean_ms": float(np.mean(xs)) * 1e3,
                             "p99_ms": self._pct(xs, 99) * 1e3,
                             "count": h.count}
        out = {
            "submitted": self._c_submitted.value,
            "completed": completed,
            "shed": self._c_shed.value,
            "cancelled": self._c_cancelled.value,
            "service_ewma_ms": ((ewma or 0.0) * 1e3),
            "phases": phases,
            "throughput_rps": tput,
            "replicas": self.replicas,
            "throughput_per_replica_rps": tput / self.replicas,
            "latency_samples": len(lat),
            "latency_p50_ms": self._pct(lat, 50) * 1e3 if lat else None,
            "latency_p99_ms": self._pct(lat, 99) * 1e3 if lat else None,
            "latency_mean_ms": float(np.mean(lat)) * 1e3 if lat else None,
            "queue_depth_mean": (float(np.mean(depths))
                                 if depths else 0.0),
            "queue_depth_max": (int(max(depths)) if depths else 0),
            "batch_size_mean": (float(np.mean(sizes))
                                if sizes else 0.0),
        }
        if flat:
            from repro_torch.obs.exporter import flatten_report
            return flatten_report(out)
        return out

    def report(self, *, cache: Any = None,
               modeled: dict[str, Any] | None = None) -> dict[str, Any]:
        """``measured`` metrics next to the Fig. 1 ``modeled`` prediction."""
        out: dict[str, Any] = {"measured": self.snapshot()}
        if cache is not None:
            out["cache"] = cache.stats.as_dict()
        if modeled is not None:
            out["modeled"] = modeled
        return out
