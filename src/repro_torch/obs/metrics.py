"""Unified metrics registry: counters, gauges, reservoir histograms.

Copy of :mod:`repro.obs.metrics`, with the same string-seeded
reservoirs, so the same observations give the same summaries (and the
same OpenMetrics text) in both packages.

One registry per serving engine (or per process) holds every metric
the runtime publishes — :class:`~repro_torch.runtime.telemetry.Telemetry`
stores its samples *here* instead of keeping private lists, so an
operator (or an exporter grown later) can enumerate everything a
component measures through one interface.

:class:`Histogram` keeps a **uniform reservoir** (Vitter's Algorithm
R) rather than the first-N samples: a long serving run's p99 tracks
the *whole* run, not the warm-up era.  The reservoir RNG is seeded
from the metric name, so two runs observing the same stream keep the
same samples — deterministic tests, reproducible reports.

>>> reg = MetricsRegistry()
>>> reg.counter("served").inc(3)
>>> h = reg.histogram("latency_s", capacity=4)
>>> for x in range(100):
...     h.observe(float(x))
>>> h.count, len(h.samples())
(100, 4)
>>> reg.as_dict()["served"]
3
"""
from __future__ import annotations

import random
import threading
from typing import Any, Iterator

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically increasing count (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def as_value(self) -> int:
        return self._value


class Gauge:
    """A point-in-time value (thread-safe set/read)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: float | None = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float | None:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None

    def as_value(self) -> float | None:
        return self._value


class Histogram:
    """Uniform reservoir of observations (Algorithm R, seeded).

    Every observation is *counted*; at most ``capacity`` samples are
    *kept*, each surviving with probability ``capacity / count`` — so
    percentiles reflect the full stream uniformly instead of freezing
    on the first ``capacity`` observations.  The RNG is seeded from
    ``(name, seed)`` (string-seeded ``random.Random``: stable across
    processes and runs), and :meth:`reset` re-seeds it, so a reset
    measurement window replays deterministically.
    """

    __slots__ = ("name", "capacity", "_seed", "_samples", "_count",
                 "_sum", "_rand", "_lock")

    def __init__(self, name: str, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self._seed = seed
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._rand = random.Random(f"{name}:{seed}")
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._observe(x)

    def extend(self, xs) -> None:
        with self._lock:
            for x in xs:
                self._observe(x)

    def _observe(self, x: float) -> None:
        x = float(x)
        self._count += 1
        if np.isfinite(x):          # a NaN/inf sample must not poison sum
            self._sum += x
        if len(self._samples) < self.capacity:
            self._samples.append(x)
            return
        j = self._rand.randrange(self._count)
        if j < self.capacity:
            self._samples[j] = x

    @property
    def count(self) -> int:
        """Total observations (not just the retained samples)."""
        return self._count

    @property
    def sum(self) -> float:
        """Running sum of every *finite* observation (whole stream)."""
        return self._sum

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def finite_samples(self) -> list[float]:
        """Retained samples with NaN/inf filtered out.

        A hung launch or wrapped clock can observe a non-finite value;
        keeping it in the reservoir is honest accounting, but every
        percentile/mean consumer (and any exported JSON) wants only
        the digestible part.
        """
        with self._lock:
            return [x for x in self._samples if np.isfinite(x)]

    def percentile(self, q: float) -> float:
        xs = self.finite_samples()
        if not xs:
            return 0.0
        return float(np.percentile(np.asarray(xs), q))

    def mean(self) -> float:
        xs = self.finite_samples()
        return float(np.mean(xs)) if xs else 0.0

    def max(self) -> float:
        xs = self.finite_samples()
        return max(xs) if xs else 0.0

    def summary(self) -> dict[str, Any]:
        """JSON-ready stats: ``None`` (never NaN) when nothing usable.

        ``count`` is the whole observation stream, ``samples`` the
        finite retained reservoir the percentiles come from — a
        ``samples == 0`` summary carries ``None`` percentiles so an
        empty reservoir can never masquerade as a 0-latency one.
        """
        xs = np.asarray(self.finite_samples())
        if not len(xs):
            return {"count": self._count, "samples": 0, "sum": self._sum,
                    "mean": None, "p50": None, "p99": None, "max": None}
        return {"count": self._count, "samples": int(len(xs)),
                "sum": self._sum, "mean": float(np.mean(xs)),
                "p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99)),
                "max": float(xs.max())}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._sum = 0.0
            self._rand = random.Random(f"{self.name}:{self._seed}")

    def as_value(self) -> dict[str, float]:
        return self.summary()


class MetricsRegistry:
    """Name -> metric table with get-or-create accessors.

    Accessors are idempotent: ``counter("x")`` twice returns the same
    object; asking for an existing name as a *different* metric type
    raises.  ``as_dict()`` renders every metric for a report and
    ``reset()`` zeroes them all (a measurement-window boundary).
    """

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, *args) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, capacity: int = 4096,
                  seed: int = 0) -> Histogram:
        return self._get_or_create(name, Histogram, capacity, seed)

    def get(self, name: str) -> Any | None:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def __iter__(self) -> Iterator[Any]:
        with self._lock:
            items = list(self._metrics.values())
        return iter(items)

    def __len__(self) -> int:
        return len(self._metrics)

    def as_dict(self) -> dict[str, Any]:
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.as_value() for name, m in items}

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()
