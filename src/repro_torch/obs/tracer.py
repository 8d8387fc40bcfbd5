"""Compile-span recorder: the part of :mod:`repro.obs.tracer` that
``compile_graph`` and ``build_schedule`` use.

A :class:`Tracer` keeps a bounded ring of ``B``/``E`` span events with
attributes; ``maybe_span`` is a no-op when no tracer is given, so an
untraced compile pays one ``None`` check per site.  The process-global
tracer, async request spans and the Chrome exporter of the reference
wait for the serving slice.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

__all__ = ["Event", "Tracer", "maybe_span", "resolve_tracer"]

DEFAULT_CAPACITY = 1 << 16


class Event:
    """One recorded event: phase ``B`` or ``E``, name, time, attributes."""

    __slots__ = ("ph", "name", "cat", "ts", "tid", "args")

    def __init__(self, ph: str, name: str, cat: str, ts: float, tid: int,
                 args: dict[str, Any] | None):
        self.ph, self.name, self.cat = ph, name, cat
        self.ts, self.tid, self.args = ts, tid, args

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event({self.ph} {self.name} {self.args})"


class _NoopSpan:
    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _SpanCtx:
    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict[str, Any] | None):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.attrs = attrs
        self.exit_attrs: dict[str, Any] = {}

    def set(self, **attrs: Any) -> "_SpanCtx":
        self.exit_attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        self.tracer._emit("B", self.name, self.cat, self.attrs)
        return self

    def __exit__(self, *exc: Any) -> None:
        self.tracer._emit("E", self.name, self.cat, self.exit_attrs or None)


class Tracer:
    """Thread-safe bounded ring of span events; the oldest drop first.

    >>> tr = Tracer(capacity=8)
    >>> with tr.span("work", n=1) as sp:
    ...     _ = sp.set(done=True)
    >>> [e.ph for e in tr.events()]
    ['B', 'E']
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0
        self._events: deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _emit(self, ph: str, name: str, cat: str,
              args: dict[str, Any] | None) -> None:
        ts = (time.perf_counter() - self._t0) * 1e6
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(Event(ph, name, cat, ts,
                                      threading.get_ident(), args))

    def span(self, name: str, cat: str = "span", **attrs: Any):
        """Thread-scoped duration span as a ``with`` context."""
        if not self.enabled:
            return _NOOP
        return _SpanCtx(self, name, cat, attrs or None)

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        # an empty tracer is still a live recorder: `tracer or ...`
        # must never drop it
        return True


def resolve_tracer(trace: Any) -> Tracer | None:
    """``None``/``False`` -> no tracing; ``True`` -> a private tracer;
    a :class:`Tracer` passes through (a disabled one resolves to None)."""
    if trace is None or trace is False:
        return None
    if trace is True:
        return Tracer()
    if not isinstance(trace, Tracer):
        raise TypeError(f"trace must be a Tracer, True/False or None; "
                        f"got {type(trace).__name__}")
    return trace if trace.enabled else None


def maybe_span(tracer: Tracer | None, name: str, cat: str = "span",
               **attrs: Any):
    """``tracer.span(...)`` or a shared no-op when ``tracer`` is None."""
    if tracer is None:
        return _NOOP
    return tracer.span(name, cat, **attrs)
