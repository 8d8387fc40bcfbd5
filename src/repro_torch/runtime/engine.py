"""The streaming serving engine: an XRT-style command queue in software.

Port of :mod:`repro.runtime.engine`, with every behaviour of the
reference.  What differs is the device side: a batch is staged into
pinned host buffers and copied to the card ``non_blocking``, its
kernels launch once per fusion group for the whole batch, and one
``torch.cuda.Event`` recorded after them is what the worker polls
(``Event.query()``) to reap finished slots; a retired batch is read
back with one ``.cpu()`` per output, and each request gets numpy rows.
The worker thread enters ``torch.cuda.device(engine.device)`` before its
first launch; client threads make no CUDA call for a request (``submit``
validates shapes on the host; a cache miss compiles on the submitting
thread, as in the reference).  With ``replicas=k`` each padded batch is
split over the k devices of ``replica_mesh(k)`` (the batch-parallel
farm of :class:`~repro_torch.runtime.batching.MicroBatcher`), the
worker polls one event per device, and readback gathers every
replica's rows.

A drift ``launch`` row records the batch's *device* time: timing
events around its launches on the card, behind a launch gate that holds
the stream until the host has queued them
(:class:`~repro_torch.runtime.batching.BatchSpan`); the host time
around the batched entry on the CPU.  The sentinel then refits the cost
model from what the model prices.  The reference records the whole
service time (staging, launch and readback) there; ``svc`` stays in the
telemetry and in ``compile`` rows.

FLOWER's generated host code sets up an XRT context, buffers and a
command queue and overlaps H2D / kernel / D2H.  This module is that
runtime layer for compiled dataflow apps, grown into a long-lived
service built around **continuous batching**: the submit→dispatch→
complete hot path never drains between launches — new work joins
while earlier work is still in flight, the streaming idiom of the
paper's dataflow machines applied to the host side.

- **per-app admission queues** — each app (signature) gets its own
  bounded FIFO; a full queue exerts backpressure on ``submit``
  exactly like a finite FIFO in
  :func:`repro_torch.core.simulate.simulate_pipeline` (block, or raise
  :class:`QueueFullError` when ``block=False``).  Shedding is *per
  app*: one hot graph saturating its queue cannot reject or starve
  traffic for the others.
- **weighted fairness** — batches are formed across apps by
  deficit-weighted round-robin (``app_weights`` / ``set_app_weight``):
  an app with weight 2 forms two batches per cycle to a weight-1
  app's one, and every app with queued work is visited each cycle.
- **deadline-based batch formation** — a batch closes on ``max_batch``
  OR a per-request latency budget, whichever comes first.  The budget
  adapts from the observed per-batch service time (EWMA via
  :class:`~repro_torch.runtime.telemetry.Telemetry`): a request never waits
  longer for stragglers than a fraction of the time its batch will
  take to execute.  When the device is idle the engine is
  work-conserving and dispatches immediately — batching only ever
  delays a request when there is in-flight work to overlap with.
- **bucketed, zero-copy dispatch** — batches are padded to
  power-of-two buckets (not ``max_batch``), and request rows are
  written directly into pinned
  staging buffers (:class:`~repro_torch.runtime.batching.MicroBatcher`).
- **continuous slot refill** — launches go into a
  :class:`~repro_torch.runtime.slots.SlotPool` of in-flight slots.  The
  worker *reaps* slots the moment their outputs are ready (a
  non-blocking ``Event.query()`` probe) and refills them with the
  next batch, so the pool never drains to a barrier; it only blocks on
  the oldest slot when every slot is busy — synchronize-free
  pipelining on the card's stream.
- **cancellation** — a caller that times out can ``cancel()`` its
  request; cancelled requests free their queue slot immediately and
  are skipped at batch formation, so an abandoned request never leaks
  capacity.
- **telemetry** — queue depth, p50/p99 latency, throughput, shed and
  cancel counts, and a per-phase breakdown of the hot path
  (queue-wait / form / stack / launch / readback), reported
  side-by-side with the Fig. 1
  :func:`~repro_torch.core.simulate.analytic_latency` prediction
  (:meth:`StreamEngine.report`).

"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.graph import DataflowGraph
from repro_torch.core.host import CompiledApp
from repro_torch.core.vectorize import (device_spec, modeled_schedule_time,
                                        schedule_features)
from repro_torch.device import resolve_device
from repro_torch.obs.drift import resolve_drift
from repro_torch.obs.health import SLO, HealthMonitor
from repro_torch.obs.tracer import resolve_tracer
from repro_torch.runtime.batching import BatchSpan, MicroBatcher
from repro_torch.runtime.cache import CompileCache
from repro_torch.runtime.slots import SlotPool
from repro_torch.runtime.telemetry import (_SERVICE_ALPHA, PHASES, Telemetry,
                                     modeled_latency)

__all__ = ["QueueFullError", "CancelledError", "StreamRequest",
           "StreamEngine"]

#: adaptive formation budget = this fraction of the service-time EWMA
_BUDGET_FRACTION = 0.5
#: clamp on the adaptive formation budget (seconds)
_BUDGET_MIN_S = 1e-4
_BUDGET_MAX_S = 2e-2


def _to_host(out: Any) -> np.ndarray:
    """One batched output as a host array; a replicated output (the
    replicas' row slices) is gathered row slice by row slice."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    rows = sum(s.shape[0] for s in out)
    host = torch.empty((rows, *out[0].shape[1:]), dtype=out[0].dtype)
    r0 = 0
    for s in out:
        host[r0:r0 + s.shape[0]].copy_(s)
        r0 += s.shape[0]
    return host.numpy()


class QueueFullError(RuntimeError):
    """An app's bounded request queue rejected a submit (shed)."""


class CancelledError(RuntimeError):
    """The request was cancelled by its caller before completion."""


class StreamRequest:
    """Future-like handle for one submitted request."""

    def __init__(self, app: CompiledApp, inputs: Mapping[str, Any]):
        self.app = app
        self.inputs = dict(inputs)
        self.t_submit = time.perf_counter()
        self.t_taken: float | None = None
        #: per-request correlation id, set by a *traced* engine at
        #: submit; every span of this request's life carries it
        self.trace_id: int | None = None
        self._lock = threading.Lock()
        # the wakeup Event is allocated lazily by the first waiter: a
        # request that completes before anyone blocks on it (the common
        # case under load — callers poll handles in submission order)
        # never pays for one
        self._event: threading.Event | None = None
        self._completed = False
        self._result: dict[str, np.ndarray] | None = None
        self._error: BaseException | None = None
        self._release = None          # engine hook: free queue slot on cancel

    def done(self) -> bool:
        return self._completed

    def cancelled(self) -> bool:
        """True when the request was abandoned via :meth:`cancel`."""
        return isinstance(self._error, CancelledError)

    def _wait(self, timeout: float | None) -> bool:
        if self._completed:
            return True
        with self._lock:
            if self._completed:
                return True
            if self._event is None:
                self._event = threading.Event()
            event = self._event
        return event.wait(timeout)

    def result(self, timeout: float | None = None) -> dict[str, np.ndarray]:
        """Block until served; return per-output host arrays.

        Raises :class:`TimeoutError` when ``timeout`` expires — the
        request is still queued and will be served; call
        :meth:`cancel` to abandon it without leaking its queue slot.
        """
        if not self._wait(timeout):
            raise TimeoutError("request not served within timeout; "
                               "cancel() to abandon it")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._wait(timeout):
            raise TimeoutError("request not served within timeout; "
                               "cancel() to abandon it")
        return self._error

    def cancel(self) -> bool:
        """Abandon a not-yet-completed request.

        Returns True if the request was cancelled (it will never
        produce a result; ``result()`` raises :class:`CancelledError`),
        False if it had already completed.  A cancelled request frees
        its queue slot immediately; if its batch is already in flight
        the computed row is simply discarded on retirement.
        """
        with self._lock:
            if self._completed:
                return False
            self._error = CancelledError("request cancelled by caller")
            self._completed = True
            if self._event is not None:
                self._event.set()
        release, self._release = self._release, None
        if release is not None:
            release(self)
        return True

    # engine-side completion (first of finish/fail/cancel wins)
    def _finish_quiet(self, result: dict[str, np.ndarray]
                      ) -> tuple[bool, "threading.Event | None"]:
        """Claim completion WITHOUT waking waiters.

        Returns ``(won, event)``; the caller must ``event.set()`` once
        its own bookkeeping (telemetry, slot release) is consistent —
        so a client that wakes from ``result()`` and immediately calls
        ``report()`` sees its own completion counted.
        """
        with self._lock:
            if self._completed:
                return False, None
            self._result = result
            self._completed = True
            return True, self._event

    def _finish(self, result: dict[str, np.ndarray]) -> bool:
        won, event = self._finish_quiet(result)
        if event is not None:
            event.set()
        return won

    def _fail(self, err: BaseException) -> bool:
        with self._lock:
            if self._completed:
                return False
            self._error = err
            self._completed = True
            if self._event is not None:
                self._event.set()
            return True


class _AppQueue:
    """One app's bounded FIFO + fairness/shed accounting."""

    __slots__ = ("app", "q", "weight", "credit", "shed", "batches",
                 "served")

    def __init__(self, app: CompiledApp, weight: float = 1.0):
        self.app = app
        self.q: deque[StreamRequest] = deque()
        self.weight = weight
        self.credit = weight
        self.shed = 0            # admissions rejected (QueueFullError)
        self.batches = 0         # batches formed for this app
        self.served = 0          # requests taken into batches


class StreamEngine:
    """Long-lived serving engine for compiled dataflow apps.

    Usage::

        with StreamEngine(max_batch=8) as eng:      # cuda_stream, the card
            handles = [eng.submit(graph, {"x": img}) for img in imgs]
            results = [h.result(timeout=60) for h in handles]
            print(eng.report())

    ``device`` defaults to the card (``None`` -> ``cuda``; without one
    :class:`~repro_torch.device.DeviceUnavailableError`); pass
    ``device="cpu"`` to serve the plain versions on the CPU.  Request
    inputs are host arrays (numpy or CPU tensors); results are numpy.
    ``max_queue`` is the FIFO depth of each *per-app* request queue
    (the backpressure bound; ``max_pending`` optionally bounds the
    total across apps), ``max_batch`` the micro-batch width cap,
    ``inflight`` the number of outstanding batches on the card (2 ==
    double buffering).  ``latency_budget`` (seconds) bounds how long
    a request may wait for its batch to fill; when ``None`` the
    budget adapts from the measured per-batch service time, seeded by
    ``linger``.  ``app_weights`` maps graph names to fairness weights
    for the deficit round-robin batch former (default 1.0 each).
    Extra keyword arguments are forwarded to
    :func:`repro_torch.core.compiler.compile_graph` on cache misses,
    with ``device=`` set to the engine's.

    The observability plane: ``trace=`` records every request's phase
    timeline into a :class:`~repro_torch.obs.tracer.Tracer`;
    ``drift=`` appends (modeled, measured) rows to a
    :class:`~repro_torch.obs.drift.DriftLog`; ``slo=`` sets the
    :class:`~repro_torch.obs.health.SLO` that :meth:`health` (and a
    rate-limited worker-loop sweep) evaluates with hysteresis; and
    :meth:`openmetrics` / :meth:`serve_metrics` expose everything as
    an OpenMetrics scrape with stable ``backend``/``device``/``app``
    labels.  ``sentinel=True`` (with ``drift=``), a
    :class:`~repro_torch.obs.sentinel.SentinelPolicy` or a
    :class:`~repro_torch.obs.sentinel.DriftSentinel` arms the sentinel
    that refits the cost model from the drift rows when its fit goes
    stale (polled from the worker's idle loop).  ``tune="auto"`` and
    ``calibrate=`` reach :func:`~repro_torch.core.compiler.compile_graph`
    through the cache.  ``donate=`` is accepted and has no effect.

    ``replicas=k`` shards every padded micro-batch across the k devices
    of :func:`~repro_torch.parallel.sharding.replica_mesh` on the
    engine's device type — the batch-parallel farm: each device runs
    one full pipeline replica on ``batch/k`` rows, and the report shows
    measured per-replica throughput next to the model's predicted
    scaling.  On ``cuda`` that is the first k cards, so asking for more
    than the host has raises ``ValueError``; on ``cpu`` it is k copies
    of the CPU.
    """

    def __init__(self, *, backend="cuda_stream", device: Any = None,
                 max_queue: int = 64,
                 max_batch: int = 8, inflight: int = 2, donate: bool = True,
                 replicas: int = 1,
                 cache: CompileCache | None = None,
                 telemetry: Telemetry | None = None,
                 poll_interval: float = 0.005, linger: float = 0.002,
                 latency_budget: float | None = None,
                 bucket_pad: bool = True,
                 app_weights: Mapping[str, float] | None = None,
                 max_pending: int | None = None,
                 autostart: bool = True, trace: Any = None,
                 drift: Any = None, slo: SLO | None = None,
                 sentinel: Any = None, **compile_kwargs: Any):
        from repro_torch.backends import resolve
        from repro_torch.parallel.sharding import replica_mesh
        #: the resolved Backend record; its cache_key() keys every
        #: compile below
        self.backend = resolve(backend)
        self.device = resolve_device(device)
        #: the replicas' devices (the engine's own device for one)
        self.mesh = replica_mesh(
            replicas, devices=[self.device] if replicas == 1 else None,
            device=self.device)
        # the devices whose streams a batch's readiness events sit on
        self._streams = list(dict.fromkeys(self.mesh.devices))
        #: the spec compile_graph models this device with (drift rows)
        self._spec = device_spec(self.device)
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.replicas = replicas
        self.latency_budget = latency_budget
        self.cache = cache or CompileCache()
        self.telemetry = telemetry or Telemetry()
        self.telemetry.replicas = replicas
        # flight recorder + drift log, both None unless asked for
        # (trace=True/Tracer/$REPRO_TRACE, drift=True/path/DriftLog/
        # $REPRO_DRIFT_LOG) — the hot path guards every emission with
        # an `is not None` check, so the untraced engine pays nothing
        self.tracer = resolve_tracer(trace)
        self.drift = resolve_drift(drift)
        self._backend_key = self.backend.cache_key()
        # SLO health monitor: always present (engine.health() must
        # answer), objectives default to the latency budget + a 5%
        # shed-rate ceiling unless the caller passes an SLO
        self._health = HealthMonitor(
            slo if slo is not None else SLO(latency_p99_s=latency_budget),
            registry=self.telemetry.registry, tracer=self.tracer)
        self._metrics_server: Any = None
        # drift sentinel: off unless asked (True/SentinelPolicy/instance)
        self.sentinel = self._resolve_sentinel(sentinel)
        self._modeled_s: dict[str, float] = {}   # sig -> modeled s/item
        self._features: dict[str, dict] = {}     # sig -> drift features
        self._launched: set[tuple[str, int]] = set()  # warm (sig, width)
        self._compile_kwargs = dict(compile_kwargs, device=self.device)
        self._bucket_pad = bucket_pad
        self._weights: dict[str, float] = dict(app_weights or {})
        self._cond = threading.Condition()
        self._queues: dict[str, _AppQueue] = {}     # sig -> app queue
        self._rr: deque[str] = deque()              # round-robin order
        self._pending = 0                           # queued across apps
        self._pool = SlotPool(inflight)
        # staging_depth must EXCEED inflight: a batch is staged before
        # the oldest slot is retired, so `inflight` batches can be
        # unretired while the next one stages — and the non_blocking
        # copy from pinned memory reads a rotation after launch()
        # returns, so a rotation may be rewritten only once the batch
        # that used it has been retired (read back).
        self._batcher = MicroBatcher(max_batch=max_batch, donate=donate,
                                     replicas=replicas,
                                     devices=list(self.mesh.devices),
                                     staging_depth=inflight + 1,
                                     trace=self.tracer
                                     if self.tracer is not None else False)
        self._apps: dict[str, CompiledApp] = {}
        self._io_specs: dict[str, list[tuple[str, tuple]]] = {}
        self._form_obs: dict[str, Any] = {}   # worker-only scratch
        # telemetry is flushed in bulk — per-metric lock round-trips
        # on the hot path cost as much as a small batch's kernel
        self._obs: list = []
        self._obs_lock = threading.Lock()
        # held across a flush's swap AND ingest: a reader's flush must
        # not return while another thread's swapped-out entries are still
        # on their way into the telemetry
        self._flush_lock = threading.Lock()
        self._sub_count = 0
        self._sub_depths: list[int] = []
        self._service_ewma: float | None = None  # worker-local copy
        self._poll = poll_interval
        self._linger = linger                       # adaptive-budget seed
        self._form_wait = poll_interval             # next formation deadline
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def submit(self, graph: DataflowGraph | CompiledApp,
               inputs: Mapping[str, Any], *, block: bool = True,
               timeout: float | None = None) -> StreamRequest:
        """Enqueue one request; returns a future-like handle.

        ``graph`` may be a raw (even non-canonical) graph — it is
        compiled through the cache on this thread — or an already
        compiled app.  When the app's bounded queue is full, ``submit``
        blocks (bounded by ``timeout``) or, with ``block=False``,
        raises :class:`QueueFullError` — admission control sheds load
        for THIS app only; other apps keep their own headroom.
        """
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        if isinstance(graph, CompiledApp):
            app = graph
            if app.device != self.device:
                raise ValueError(f"app {app.graph.name!r} was compiled for "
                                 f"{app.device}; this engine serves "
                                 f"{self.device}")
        elif self.tracer is not None:
            app = self.cache.get(graph, backend=self.backend,
                                 trace=self.tracer, **self._compile_kwargs)
        else:
            app = self.cache.get(graph, backend=self.backend,
                                 **self._compile_kwargs)
        sig = app.signature()
        # validate on admission: a malformed request must fail ITS
        # submit, not poison the micro-batch it would have joined
        # (the per-app (name, shape) spec is cached — the graph is
        # frozen once compiled)
        specs = self._io_specs.get(sig)
        if specs is None:
            self._apps.setdefault(sig, app)
            specs = [(ch.name, tuple(ch.shape))
                     for ch in app.graph.graph_inputs]
            self._io_specs[sig] = specs
        for name, shape in specs:
            if name not in inputs:
                raise ValueError(f"missing graph input {name!r}")
            got = getattr(inputs[name], "shape", None)
            if got != shape and tuple(np.shape(inputs[name])) != shape:
                raise ValueError(f"input {name!r}: expected shape "
                                 f"{shape}, got "
                                 f"{tuple(np.shape(inputs[name]))}")
        req = StreamRequest(app, inputs)
        if self.tracer is not None:
            req.trace_id = self.tracer.new_id()
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            aq = self._queues.get(sig)
            if aq is None:
                aq = _AppQueue(app, self._weights.get(app.graph.name, 1.0))
                self._queues[sig] = aq
                self._rr.append(sig)
            while self._is_full(aq):
                if not block:
                    aq.shed += 1
                    self.telemetry.observe_shed()
                    raise QueueFullError(
                        f"app {app.graph.name!r} at FIFO depth "
                        f"{self.max_queue}; retry with block=True, raise "
                        f"max_queue, or shed load for this app")
                remaining = (None if end is None
                             else end - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    aq.shed += 1
                    self.telemetry.observe_shed()
                    raise QueueFullError(
                        f"app {app.graph.name!r} still at FIFO depth "
                        f"{self.max_queue} after {timeout}s")
                self._cond.wait(remaining)
                if self._stop.is_set():
                    raise RuntimeError("engine is closed")
            req._release = self._on_cancel
            aq.q.append(req)
            self._sub_count += 1
            if len(self._sub_depths) < 100_000:
                self._sub_depths.append(self._pending)
            self._pending += 1
            self._cond.notify_all()
        if self._stop.is_set() and (self._thread is None
                                    or not self._thread.is_alive()):
            # raced a concurrent close(): the worker is gone and will
            # never drain this request — fail it instead of hanging
            self._fail_all(RuntimeError("engine closed"))
        return req

    def set_app_weight(self, name: str, weight: float) -> None:
        """Set the fairness weight for every app named ``name``."""
        with self._cond:
            self._weights[name] = weight
            for aq in self._queues.values():
                if aq.app.graph.name == name:
                    aq.weight = weight

    def report(self, n_items: int | None = None) -> dict[str, Any]:
        """Measured serving metrics + Fig. 1 model, side by side."""
        self._flush_obs()
        n = n_items or max(1, self.telemetry.completed)
        modeled: dict[str, Any] = {}
        for sig, app in self._apps.items():
            key = app.graph.name
            if key in modeled:               # names are arbitrary labels
                key = f"{key}@{sig[:6]}"
            modeled[key] = modeled_latency(app, n, depth=self.max_queue,
                                           replicas=self.replicas)
            modeled[key]["tile_provenance"] = sorted(
                {g.tile_source for g in app.schedule.groups
                 if g.tile is not None})
        out = self.telemetry.report(cache=self.cache, modeled=modeled)
        apps: dict[str, Any] = {}
        with self._cond:
            for sig, aq in self._queues.items():
                key = aq.app.graph.name
                if key in apps:
                    key = f"{key}@{sig[:6]}"
                apps[key] = {"weight": aq.weight, "queued": len(aq.q),
                             "batches": aq.batches, "served": aq.served,
                             "shed": aq.shed}
        out["apps"] = apps
        out["buckets"] = dict(self._batcher.bucket_launches)
        return out

    # ------------------------------------------------------------------
    # observability plane: health, sentinel, OpenMetrics
    # ------------------------------------------------------------------
    def _resolve_sentinel(self, sentinel: Any):
        """Normalize the ``sentinel=`` argument (None/False = off)."""
        if sentinel is None or sentinel is False:
            return None
        from repro_torch.obs.sentinel import DriftSentinel, SentinelPolicy
        if isinstance(sentinel, DriftSentinel):
            # adopt a pre-built sentinel into this engine's telemetry
            # plane (unless the caller wired its own sinks)
            if sentinel.registry is None:
                sentinel.registry = self.telemetry.registry
            if sentinel.tracer is None:
                sentinel.tracer = self.tracer
            return sentinel
        if self.drift is None:
            raise ValueError("sentinel= needs drift rows: pass drift=True "
                             "(or a path/DriftLog) alongside it")
        policy = sentinel if isinstance(sentinel, SentinelPolicy) else None
        if not (sentinel is True or policy is not None):
            raise TypeError(f"sentinel must be True/False/None, a "
                            f"SentinelPolicy or a DriftSentinel; got "
                            f"{sentinel!r}")
        return DriftSentinel(self.drift, self.backend, policy=policy,
                             registry=self.telemetry.registry,
                             tracer=self.tracer, device=self.device,
                             spec=self._spec)

    def health(self) -> dict[str, Any]:
        """Evaluate the SLOs now; returns the health verdict.

        ``{"state": "healthy" | "degraded" | "breach", "violated":
        [...], "objectives": {...}}`` — see
        :class:`~repro_torch.obs.health.HealthMonitor`.  The worker also
        evaluates periodically while serving, so state transitions
        land in the tracer/registry even if nobody polls this.
        """
        self._flush_obs()
        stats = self.cache.stats
        hit_rate = stats.hit_rate if stats.requests else None
        with self._cond:
            qd = self._pending
        return self._health.evaluate(
            submitted=self.telemetry.submitted, shed=self.telemetry.shed,
            queue_depth=qd, cache_hit_rate=hit_rate)

    def _periodic(self) -> None:
        """Idle-loop upkeep: rate-limited health and sentinel sweeps.

        Failures here must never take the worker down with them — a
        sentinel refit hitting a torn store is telemetry's problem, not
        the serving path's.
        """
        try:
            stats = self.cache.stats
            self._health.maybe_evaluate(
                submitted=self.telemetry.submitted,
                shed=self.telemetry.shed, queue_depth=self._pending,
                cache_hit_rate=(stats.hit_rate if stats.requests
                                else None))
            if self.sentinel is not None:
                self.sentinel.poll()
        except Exception:
            if self.tracer is not None:
                self.tracer.instant("obs.periodic_error", cat="health")

    def metric_families(self) -> dict[str, Any]:
        """The engine's full exposition, as typed metric families.

        Everything in the telemetry registry (latency/queue/batch
        summaries, phase histograms folded into one ``phase_seconds``
        family with a ``phase`` label, health and sentinel counters) plus
        per-app admission counters and per-bucket launch counts — all
        stamped with the stable identity labels ``backend`` (the
        resolved backend's ``cache_key()``) and ``device`` kind.
        """
        from repro_torch.obs.exporter import MetricFamily, registry_families
        from repro_torch.tune.store import detect_device_kind
        self._flush_obs()
        base = {"backend": self._backend_key,
                "device": detect_device_kind(self.device)}
        rules = {f"phase_{p}_s": ("phase_seconds", {"phase": p})
                 for p in PHASES}
        fams = registry_families(self.telemetry.registry, labels=base,
                                 rules=rules)
        app_gauge = MetricFamily("repro_app_queued", "gauge",
                                 "requests queued per app")
        app_weight = MetricFamily("repro_app_weight", "gauge",
                                  "fairness weight per app")
        app_served = MetricFamily("repro_app_served", "counter",
                                  "requests taken into batches per app")
        app_shed = MetricFamily("repro_app_shed", "counter",
                                "admissions rejected per app")
        app_batches = MetricFamily("repro_app_batches", "counter",
                                   "batches formed per app")
        with self._cond:
            rows = [(aq.app.graph.name, sig, len(aq.q), aq.weight,
                     aq.served, aq.shed, aq.batches)
                    for sig, aq in self._queues.items()]
        for name, sig, queued, weight, served, shed, batches in rows:
            labels = dict(base, app=name, signature=sig[:12])
            app_gauge.add(queued, labels)
            app_weight.add(weight, labels)
            app_served.add(served, labels, "_total")
            app_shed.add(shed, labels, "_total")
            app_batches.add(batches, labels, "_total")
        buckets = MetricFamily("repro_bucket_launches", "counter",
                               "kernel launches per padded batch width")
        for width, n in sorted(self._batcher.bucket_launches.items()):
            buckets.add(n, dict(base, width=width), "_total")
        for fam in (app_gauge, app_weight, app_served, app_shed,
                    app_batches, buckets):
            if fam.samples:
                fams[fam.name] = fam
        if self.drift is not None and self.drift.max_rows is not None:
            rot = MetricFamily("repro_drift_rotated_rows", "counter",
                               "drift rows retired by log rotation")
            rot.add(self.drift.rotated_rows, base, "_total")
            fams[rot.name] = rot
        return fams

    def openmetrics(self) -> str:
        """The live OpenMetrics/Prometheus exposition text."""
        from repro_torch.obs.exporter import render_openmetrics
        return render_openmetrics(self.metric_families())

    def serve_metrics(self, *, host: str = "127.0.0.1", port: int = 0):
        """Start (or return) the scrape endpoint for this engine.

        Returns the :class:`~repro_torch.obs.exporter.MetricsHTTPServer`;
        its ``.url`` is what a Prometheus scrape config points at.
        The endpoint dies with the engine (``close()``).
        """
        if self._metrics_server is None:
            from repro_torch.obs.exporter import MetricsHTTPServer
            self._metrics_server = MetricsHTTPServer(self.openmetrics,
                                                     host=host, port=port)
        return self._metrics_server

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._serve,
                                            name="stream-engine",
                                            daemon=True)
            self._thread.start()

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; drain everything already queued."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if wait and self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if wait:
            # a submit that raced past the closed check must not hang
            self._fail_all(RuntimeError("engine closed"))
        if self.drift is not None:
            self.drift.flush()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    def __enter__(self) -> "StreamEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------
    # worker side: reap → form → dispatch, continuously
    # ------------------------------------------------------------------
    def _serve(self) -> None:
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with on_card:
                self._serve_loop()
        except BaseException as e:  # worker must never die silently
            self._fail_all(e)
            raise
        finally:
            self._flush_obs()

    def _serve_loop(self) -> None:
        while True:
            self._reap()                   # free completed slots now
            batch = self._form_batch()
            if batch:
                self._dispatch(batch)
                continue
            if self._pool.active and (self._pending == 0
                                      or self._stop.is_set()
                                      or not self._pool.free_slots()):
                # nothing formable: finishing in-flight work is the
                # only useful blocking thing left to do
                self._retire(self._pool.oldest())
                continue
            if (self._stop.is_set() and self._pending == 0
                    and not self._pool.active):
                break
            self._flush_obs()      # idle: sync deferred telemetry
            self._periodic()       # rate-limited health + sentinel
            self._wait_for_work()

    def _flush_obs(self) -> None:
        """Push buffered hot-path observations into shared telemetry.

        The worker buffers per-batch/per-submit observations locally
        (see ``_obs``) and flushes when idle, on backlog, and on
        shutdown; ``report()`` flushes too, so readers always see
        current numbers.  Safe from any thread: a flush returns only
        after every observation buffered before it is in the telemetry,
        even one another thread's flush had already taken.
        """
        with self._flush_lock:
            with self._obs_lock:
                entries, self._obs = self._obs, []
            if entries:
                self.telemetry.observe_batches(entries)
            with self._cond:
                count, self._sub_count = self._sub_count, 0
                depths, self._sub_depths = self._sub_depths, []
            if count:
                self.telemetry.observe_submits(count, depths)

    def _is_full(self, aq: _AppQueue) -> bool:
        return (len(aq.q) >= self.max_queue
                or (self.max_pending is not None
                    and self._pending >= self.max_pending))

    def _form_budget(self) -> float:
        """Max time a request may wait for its batch to fill (seconds).

        Explicit ``latency_budget`` wins; otherwise adapt to a
        fraction of the observed per-batch service time — batching is
        only worth delaying a request for when the batch it joins
        amortizes more than that delay.
        """
        if self.latency_budget is not None:
            return self.latency_budget
        s = self._service_ewma          # worker-local: no lock on this path
        if s is None:
            return self._linger
        return min(max(_BUDGET_FRACTION * s, _BUDGET_MIN_S), _BUDGET_MAX_S)

    def _pick_app(self) -> _AppQueue | None:
        """Deficit-weighted round-robin over apps with queued work.

        Called under ``_cond``.  Each selection costs one credit;
        credits replenish by ``weight`` when no queued app can pay,
        so an app with weight w forms w batches per replenish cycle
        and every queued app is visited each cycle (no starvation).
        """
        live = [s for s in self._rr if self._queues[s].q]
        if not live:
            return None
        if len(live) == 1:                    # single-tenant fast path
            return self._queues[live[0]]
        for _round in range(2):
            for _ in range(len(self._rr)):
                sig = self._rr[0]
                self._rr.rotate(-1)
                aq = self._queues[sig]
                if aq.q and aq.credit >= 1.0:
                    return aq
            for q in self._queues.values():   # weighted replenish
                q.credit = min(q.credit + q.weight, max(q.weight, 1.0))
        return self._queues[live[0]]          # weight<=0 guard: plain FIFO

    def _form_batch(self) -> list[StreamRequest]:
        """Deadline-based batch formation (the continuous-batching core).

        Close a batch when it is full, the engine is draining, the
        oldest request has spent its formation budget, or the device
        is idle (work-conserving: never hold work back when there is
        nothing to overlap it with).  Otherwise leave the batch *open*
        — arriving same-app requests keep joining it — and tell the
        worker when the deadline lands.
        """
        now = time.perf_counter()
        with self._cond:
            aq = self._pick_app()
            if aq is None:
                self._form_wait = self._poll
                return []
            budget = self._form_budget()
            oldest_age = now - aq.q[0].t_submit
            if not (len(aq.q) >= self.max_batch or self._stop.is_set()
                    or oldest_age >= budget or self._pool.active == 0):
                self._form_wait = max(1e-5, budget - oldest_age)
                return []
            aq.credit = max(0.0, aq.credit - 1.0)
            batch: list[StreamRequest] = []
            while aq.q and len(batch) < self.max_batch:
                r = aq.q.popleft()
                self._pending -= 1
                if r.done():         # cancelled while queued (lost race)
                    continue
                r.t_taken = now
                batch.append(r)
            if batch:
                aq.batches += 1
                aq.served += len(batch)
            self._cond.notify_all()  # queue space freed: wake submitters
        if batch:
            # stashed for _dispatch to merge into ONE telemetry update
            # per batch (worker-thread-only scratch, no race)
            self._form_obs = {
                "queue_wait": [r.t_taken - r.t_submit for r in batch],
                "form": now - batch[0].t_submit,
            }
        return batch

    def _dispatch(self, batch: list[StreamRequest]) -> None:
        app = batch[0].app
        timings: dict[str, float] = {}
        # the device time of the launches, for the drift row (only
        # recorded when there is a drift log to write it to)
        span = BatchSpan() if self.drift is not None else None
        try:
            # pad to the power-of-two bucket (or the fixed max_batch
            # width with bucket_pad=False): a 2-request batch launches
            # a 2-wide kernel, not a 32-wide one
            outs = self._batcher.launch(
                app, batch,
                pad_to=None if self._bucket_pad else self.max_batch,
                timings=timings, check_shapes=False, span=span)
        except BaseException as e:
            for r in batch:
                r._fail(e)
            return
        # one event per device after the batch's copies and kernels:
        # what _reap polls
        events = None
        if self.device.type == "cuda":
            events = []
            for dev in self._streams:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                events.append(event)
        t_disp = time.perf_counter()
        self._form_obs.update(timings)
        with self._obs_lock:
            self._obs.append((t_disp, len(batch), self._form_obs,
                              None, None))
        self._form_obs = {}
        # stage boundary stamps for the per-request trace timeline,
        # reconstructed from the batcher's phase durations so the hot
        # path takes no extra clock reads
        t_s1 = t_disp - timings.get("launch", 0.0)
        t_s0 = t_s1 - timings.get("stack", 0.0)
        if not self._pool.free_slots():
            self._retire(self._pool.oldest())     # rotate: block on oldest
        self._pool.submit((batch, outs, events, t_disp, (t_s0, t_s1), span))
        self._pool.admit()

    def _reap(self) -> None:
        """Retire every in-flight slot whose outputs already landed.

        Non-blocking: readiness is the batch's events (``query()``; a
        CPU batch, which has none, is ready).  This is what keeps
        the slot pool continuously refilled instead of draining at a
        barrier.
        """
        if not self._pool.active:
            return

        def _is_ready(item: Any) -> bool:
            events = item[2]
            return events is None or all(e.query() for e in events)

        for slot in self._pool.ready(_is_ready):
            self._retire(slot)

    def _retire(self, slot: int | None) -> None:
        if slot is None:
            return
        batch, outs, _events, t_disp, stage_ts, span = self._pool.retire(slot)
        t0 = time.perf_counter()
        # blocks here until the batch is done, then copies it back
        host = {k: _to_host(v) for k, v in outs.items()}
        now = time.perf_counter()
        # claim completions quietly, record them, THEN wake waiters —
        # a caller that wakes from result() and immediately reads
        # report() must see its own completion.  Requests whose claim
        # lost to cancel() have their computed row discarded.
        done: list[float] = []
        winners: list[StreamRequest] = []
        wake: list[threading.Event] = []
        for i, req in enumerate(batch):
            won, event = req._finish_quiet(
                {k: v[i] for k, v in host.items()})
            if won:
                done.append(now - req.t_submit)
                winners.append(req)
            if event is not None:
                wake.append(event)
        svc = now - t_disp
        prev = self._service_ewma
        self._service_ewma = (svc if prev is None else
                              _SERVICE_ALPHA * svc
                              + (1.0 - _SERVICE_ALPHA) * prev)
        with self._obs_lock:
            self._obs.append((now, None, {"readback": now - t0},
                              done, svc))
            backlog = len(self._obs)
        if done:
            self._health.observe_latencies(done)
        for event in wake:
            event.set()
        # trace/drift emission AFTER waking waiters: it is retroactive
        # bookkeeping reconstructed from stamps, never waiter latency
        if self.tracer is not None or self.drift is not None:
            self._record_batch(batch, winners, host, t_disp, stage_ts,
                               t0, now, svc, span)
        if backlog >= 64:
            self._flush_obs()

    def _record_batch(self, batch: list[StreamRequest],
                      winners: list[StreamRequest],
                      host: dict[str, np.ndarray], t_disp: float,
                      stage_ts: tuple[float, float], t0: float,
                      now: float, svc: float,
                      span: BatchSpan | None = None) -> None:
        """Emit one retired batch's trace timelines and drift row.

        Runs on the worker thread at retirement, entirely from
        timestamps captured earlier — nothing here sat on the
        submit→launch path.  Each *winning* request (cancelled ones
        produce no timeline) gets a contiguous async phase chain
        ``queue_wait → form → stack → launch → execute → readback``
        tiling exactly [t_submit, complete] under its trace id.
        """
        app = batch[0].app
        sig = app.signature()
        width = next(iter(host.values())).shape[0] if host else len(batch)
        t_s0, t_s1 = stage_ts
        tr = self.tracer
        if tr is not None:
            name = app.graph.name
            for req in winners:
                aid = req.trace_id
                if aid is None:        # submitted before tracing was on
                    continue
                tt = req.t_taken if req.t_taken is not None else t_s0
                tr.async_event("request", "b", aid, ts=req.t_submit,
                               cat="request", app=name, batch=len(batch),
                               width=width)
                tr.async_span("queue_wait", aid, req.t_submit, tt,
                              cat="request")
                tr.async_span("form", aid, tt, t_s0, cat="request")
                tr.async_span("stack", aid, t_s0, t_s1, cat="request")
                tr.async_span("launch", aid, t_s1, t_disp, cat="request")
                tr.async_span("execute", aid, t_disp, t0, cat="request")
                tr.async_span("readback", aid, t0, now, cat="request")
                tr.async_event("request", "e", aid, ts=now, cat="request")
            tr.counter("engine.inflight", self._pool.active)
        if self.drift is not None:
            modeled = self._modeled_s.get(sig)
            if modeled is None:
                modeled = self._modeled_s[sig] = modeled_schedule_time(
                    app.schedule, self._spec)
                self._features[sig] = schedule_features(app.schedule,
                                                        spec=self._spec)
            kind = "launch"
            items, measured = width, svc
            if (sig, width) not in self._launched:
                self._launched.add((sig, width))
                kind = "compile"   # cold (sig, width): svc includes the build
            else:
                # the launches' device time, the frames one device ran
                # (a span exists whenever there is a drift log)
                items, measured = span.items, span.seconds()
                if measured is None:
                    return   # a gate timed out: the pair held the host
            # the features behind `modeled * items`, so a later fit can
            # re-score this launch under other constants; `compile` rows
            # keep them too (their svc includes building the kernels)
            features = dict(self._features[sig])
            if items != 1:
                features["items"] = int(items)
            self.drift.record(
                kind, sig,
                [list(shape) for _n, shape in self._io_specs.get(sig, [])],
                self.backend.name, modeled * items, measured,
                app=app.graph.name, width=width, batch=len(batch),
                backend_key=self._backend_key, features=features)

    def _wait_for_work(self) -> None:
        """Park until new work arrives or the formation deadline lands."""
        with self._cond:
            if self._stop.is_set() and self._pending:
                return
            self._cond.wait(min(self._form_wait, self._poll))
        self._form_wait = self._poll

    def _on_cancel(self, req: StreamRequest) -> None:
        """Cancel hook: free the queue slot a cancelled request holds."""
        self.telemetry.observe_cancel()
        with self._cond:
            aq = self._queues.get(req.app.signature())
            if aq is None:
                return
            try:
                aq.q.remove(req)
            except ValueError:
                return               # already taken into a batch
            self._pending -= 1
            self._cond.notify_all()  # its queue slot is free right now

    def _fail_all(self, err: BaseException) -> None:
        with self._cond:
            doomed = [r for aq in self._queues.values() for r in aq.q]
            for aq in self._queues.values():
                aq.q.clear()
            self._pending = 0
            self._cond.notify_all()
        for r in doomed:
            r._fail(err)
        while self._pool.active:
            batch = self._pool.retire(self._pool.oldest())[0]
            for r in batch:
                r._fail(err)
