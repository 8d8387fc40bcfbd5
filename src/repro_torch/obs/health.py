"""SLO health monitor: rolling-window objectives with hysteresis.

Copy of :mod:`repro.obs.health`.

A serving engine publishes a stream of measurements; an *operator*
needs one word — is this engine OK?  :class:`HealthMonitor` turns the
stream into that word.  It tracks a small set of service-level
objectives (:class:`SLO`) over rolling windows:

- **latency** — p99 of the most recent ``window`` request latencies
  against the latency budget,
- **shed rate** — requests rejected by admission control as a
  fraction of requests submitted *since the last evaluation* (a rate
  over the evaluation interval, not the whole run — an engine that
  shed during a spike an hour ago is not unhealthy now),
- **queue depth** — instantaneous total backlog,
- **cache hit rate** — the compile cache's per-event hit rate.

Each evaluation yields the set of violated objectives and feeds a
three-state machine with **hysteresis**:

``healthy -> degraded`` on the first violating evaluation (an early
warning, immediately visible), ``-> breach`` only after
``breach_after`` *consecutive* violating evaluations, and back to
``healthy`` only after ``recover_after`` consecutive clean ones (a
recovering breach passes through ``degraded``).  A metric oscillating
exactly at its threshold therefore parks the monitor in ``degraded``
— it can never flap ``healthy <-> breach``, which is the property the
white-box sequence test pins.

State transitions are emitted as instant events into the
:class:`~repro_torch.obs.tracer.Tracer` (``health.transition``, cat
``health``) and counted in the :class:`~repro_torch.obs.metrics.MetricsRegistry`
(``health_transitions``, ``health_violation_<objective>``, and the
``health_state`` gauge: 0 healthy / 1 degraded / 2 breach), so the
OpenMetrics exporter (:mod:`repro_torch.obs.exporter`) publishes health
exactly like every other metric.

The monitor is engine-agnostic: the
:class:`~repro_torch.runtime.engine.StreamEngine` owns one (``engine.health()``)
and feeds it latencies at batch retirement, but anything with
counters can evaluate against it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

__all__ = ["SLO", "HealthMonitor", "STATES"]

#: health states in increasing severity; the gauge exports the index
STATES = ("healthy", "degraded", "breach")


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objectives; ``None`` disables an objective.

    >>> SLO(latency_p99_s=0.05).latency_p99_s
    0.05
    """

    #: p99 of the rolling latency window must stay below this (seconds)
    latency_p99_s: float | None = None
    #: shed/submitted over the evaluation interval must stay below this
    max_shed_rate: float | None = 0.05
    #: instantaneous queued requests must stay below this
    max_queue_depth: int | None = None
    #: compile-cache per-event hit rate must stay above this
    min_cache_hit_rate: float | None = None

    def objectives(self) -> dict[str, float]:
        """The enabled objectives and their limits."""
        out: dict[str, float] = {}
        if self.latency_p99_s is not None:
            out["latency_p99"] = self.latency_p99_s
        if self.max_shed_rate is not None:
            out["shed_rate"] = self.max_shed_rate
        if self.max_queue_depth is not None:
            out["queue_depth"] = float(self.max_queue_depth)
        if self.min_cache_hit_rate is not None:
            out["cache_hit_rate"] = self.min_cache_hit_rate
        return out


class HealthMonitor:
    """Rolling-window SLO evaluation with hysteresis (thread-safe).

    ``window`` bounds the latency deque; ``breach_after`` /
    ``recover_after`` are the hysteresis widths in *evaluations*;
    ``min_interval_s`` rate-limits :meth:`maybe_evaluate` so the
    engine worker can call it every loop iteration for free.
    ``min_latency_samples`` keeps the latency objective quiet until
    the window holds enough requests for a p99 to mean anything.
    """

    def __init__(self, slo: SLO | None = None, *, window: int = 512,
                 breach_after: int = 3, recover_after: int = 3,
                 min_interval_s: float = 1.0,
                 min_latency_samples: int = 20,
                 registry: Any = None, tracer: Any = None):
        if breach_after < 1 or recover_after < 1:
            raise ValueError("breach_after and recover_after must be >= 1")
        self.slo = slo if slo is not None else SLO()
        self.window = window
        self.breach_after = breach_after
        self.recover_after = recover_after
        self.min_interval_s = min_interval_s
        self.min_latency_samples = min_latency_samples
        self.registry = registry
        self.tracer = tracer
        self.state = "healthy"
        self.evaluations = 0
        #: ``(t, from_state, to_state, violated)`` audit trail
        self.transitions: list[tuple[float, str, str, tuple[str, ...]]] = []
        self._lat: deque[float] = deque(maxlen=window)
        self._fail_streak = 0
        self._ok_streak = 0
        self._last_submitted = 0
        self._last_shed = 0
        self._last_eval_t: float | None = None
        self._lock = threading.Lock()
        if registry is not None:
            registry.gauge("health_state").set(0.0)

    # -- feeding the windows (hot-path cheap) --------------------------
    def observe_latencies(self, latencies_s) -> None:
        """Append completed-request latencies to the rolling window."""
        with self._lock:
            self._lat.extend(latencies_s)

    # -- evaluation ----------------------------------------------------
    def _measurements(self, submitted: int, shed: int, queue_depth: int,
                      cache_hit_rate: float | None) -> dict[str, Any]:
        lat = [x for x in self._lat if np.isfinite(x)]
        p99 = (float(np.percentile(np.asarray(lat), 99))
               if len(lat) >= self.min_latency_samples else None)
        d_sub = submitted - self._last_submitted
        d_shed = shed - self._last_shed
        self._last_submitted, self._last_shed = submitted, shed
        offered = d_sub + d_shed       # sheds never reach `submitted`
        shed_rate = (d_shed / offered) if offered > 0 else None
        return {"latency_p99": p99, "shed_rate": shed_rate,
                "queue_depth": float(queue_depth),
                "cache_hit_rate": cache_hit_rate,
                "latency_window": len(lat)}

    def _violations(self, meas: dict[str, Any]) -> list[str]:
        out = []
        slo = self.slo
        if (slo.latency_p99_s is not None
                and meas["latency_p99"] is not None
                and meas["latency_p99"] > slo.latency_p99_s):
            out.append("latency_p99")
        if (slo.max_shed_rate is not None
                and meas["shed_rate"] is not None
                and meas["shed_rate"] > slo.max_shed_rate):
            out.append("shed_rate")
        if (slo.max_queue_depth is not None
                and meas["queue_depth"] > slo.max_queue_depth):
            out.append("queue_depth")
        if (slo.min_cache_hit_rate is not None
                and meas["cache_hit_rate"] is not None
                and meas["cache_hit_rate"] < slo.min_cache_hit_rate):
            out.append("cache_hit_rate")
        return out

    def _advance(self, violated: list[str]) -> str:
        """The hysteresis core: one evaluation moves the state machine.

        Consecutive-evaluation counting is what prevents flapping: a
        single excursion (or a metric sitting exactly on its
        threshold, alternating pass/fail) can reach ``degraded`` but
        never ``breach``, and a breach needs ``recover_after`` clean
        evaluations in a row before the monitor calls the engine
        healthy again.
        """
        prev = self.state
        if violated:
            self._fail_streak += 1
            self._ok_streak = 0
            if self._fail_streak >= self.breach_after:
                self.state = "breach"
            elif self.state == "healthy":
                self.state = "degraded"
        else:
            self._ok_streak += 1
            self._fail_streak = 0
            if self._ok_streak >= self.recover_after:
                self.state = "healthy"
            elif self.state == "breach":
                self.state = "degraded"
        return prev

    def evaluate(self, *, submitted: int = 0, shed: int = 0,
                 queue_depth: int = 0,
                 cache_hit_rate: float | None = None,
                 now: float | None = None) -> dict[str, Any]:
        """Evaluate every objective; advance the state machine once.

        Returns ``{"state", "violated", "objectives", "evaluations",
        "transitioned"}`` where ``objectives`` maps each enabled
        objective to its measured value, limit and pass/fail (value
        ``None`` = not enough data yet, which never violates).
        """
        t = now if now is not None else time.perf_counter()
        with self._lock:
            self.evaluations += 1
            self._last_eval_t = t
            meas = self._measurements(submitted, shed, queue_depth,
                                      cache_hit_rate)
            violated = self._violations(meas)
            prev = self._advance(violated)
            state = self.state
            if state != prev:
                self.transitions.append((t, prev, state, tuple(violated)))
        transitioned = state != prev
        reg = self.registry
        if reg is not None:
            reg.counter("health_evaluations").inc()
            reg.gauge("health_state").set(float(STATES.index(state)))
            for obj in violated:
                reg.counter(f"health_violation_{obj}").inc()
            if transitioned:
                reg.counter("health_transitions").inc()
        if transitioned and self.tracer is not None:
            self.tracer.instant("health.transition", cat="health",
                                ts=t, frm=prev, to=state,
                                violated=",".join(violated))
        limits = self.slo.objectives()
        objectives = {
            name: {"value": meas.get(name), "limit": limit,
                   "ok": name not in violated}
            for name, limit in limits.items()}
        return {"state": state, "violated": violated,
                "objectives": objectives,
                "latency_window": meas["latency_window"],
                "evaluations": self.evaluations,
                "transitioned": transitioned}

    def maybe_evaluate(self, **kwargs: Any) -> dict[str, Any] | None:
        """Rate-limited :meth:`evaluate` for a worker loop.

        Returns ``None`` (and does nothing) when the last evaluation
        was under ``min_interval_s`` ago — callers can invoke it every
        iteration without turning health checking into load.
        """
        now = kwargs.get("now")
        t = now if now is not None else time.perf_counter()
        with self._lock:
            last = self._last_eval_t
            if last is not None and (t - last) < self.min_interval_s:
                return None
        kwargs.setdefault("now", t)
        return self.evaluate(**kwargs)
