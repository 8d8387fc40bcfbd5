"""The flight-recorder span tracer: a bounded, thread-safe event ring.

Copy of :mod:`repro.obs.tracer`; ``compile_graph`` and
``build_schedule`` record their ``compile.*`` spans through it, the
serving engine its request timelines.

FLOWER's users lean on the HLS toolchain's analyzers (Vitis timelines,
latency reports) to see *where* a design spends its time; this module
is that feedback channel for the reproduction.  A :class:`Tracer`
records timestamped span events into a bounded ring buffer — when the
ring is full the **oldest events are dropped** (a flight recorder
keeps the most recent history; it never blocks or grows without
bound) — and the exporter (:mod:`repro_torch.obs.export`) turns the ring
into a Chrome trace-event JSON that Perfetto loads directly.

Three recording idioms, matching how the stack is instrumented:

- ``with tracer.span("compile.lower", backend="pallas"):`` — a
  thread-scoped duration span (Chrome ``B``/``E`` pair).  Spans on one
  thread nest LIFO, so the pairs always match.  ``span(...)`` returns
  a context object whose :meth:`~_SpanCtx.set` adds result attributes
  that are recorded on exit (e.g. the tile a sweep chose).
- ``tok = tracer.begin("execute"); ...; tracer.end(tok)`` — an
  explicit begin/end pair for spans that *cross threads* (begun on a
  submitter, ended on the worker).  Recorded as one Chrome complete
  (``X``) event at ``end`` time, so it can never produce an unmatched
  ``B``/``E``.
- ``tracer.async_event("queue_wait", ph="b", aid=trace_id, ts=t0)`` —
  retroactive per-request phase spans keyed by a trace id (Chrome
  async ``b``/``e``).  The serving engine emits each request's whole
  submit→complete timeline at retirement, from timestamps captured on
  the hot path — the recording itself never sits on that path.

**Cost discipline.**  A disabled tracer (``enabled=False``) returns a
shared no-op context from ``span`` and early-outs of every record
method — a couple of attribute loads, no allocation, no lock.  Code on
hot paths guards with ``if tracer is not None`` so the off-by-default
engine pays literally nothing.

The module also owns the process-global tracer and the
``REPRO_TRACE`` environment variable that switches it on:
:func:`install` / :func:`get_tracer` / :func:`resolve_tracer`.  When
``REPRO_TRACE`` is set to a path, the global tracer auto-exports there
at interpreter exit.

This module imports nothing from the rest of the repo — any layer
(core, runtime, tune) can depend on it without cycles.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any

__all__ = ["Event", "Tracer", "install", "uninstall", "get_tracer",
           "resolve_tracer", "maybe_span", "TRACE_ENV"]

#: environment variable that enables the process-global tracer; set it
#: to ``1`` to record, or to a ``.json`` path to also auto-export a
#: Chrome trace at interpreter exit
TRACE_ENV = "REPRO_TRACE"

#: default ring capacity (events, not spans; a B/E span is two events)
DEFAULT_CAPACITY = 1 << 16


class Event:
    """One recorded trace event (a slot of the ring buffer).

    ``ph`` is the Chrome trace-event phase: ``B``/``E`` thread-scoped
    span begin/end, ``X`` complete (with ``dur``), ``b``/``e`` async
    span keyed by ``aid``, ``i`` instant, ``C`` counter sample.
    Timestamps are ``time.perf_counter()`` seconds.
    """

    __slots__ = ("ph", "name", "cat", "ts", "dur", "tid", "aid", "args",
                 "seq")

    def __init__(self, ph: str, name: str, cat: str, ts: float,
                 dur: float | None, tid: int, aid: int | None,
                 args: dict[str, Any] | None, seq: int):
        self.ph = ph
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.aid = aid
        self.args = args
        self.seq = seq

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Event({self.ph!r}, {self.name!r}, ts={self.ts:.6f}, "
                f"tid={self.tid}, aid={self.aid})")


class _NoopSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager for one thread-scoped B/E span."""

    __slots__ = ("_tracer", "_name", "_cat", "_attrs", "_exit_attrs")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict[str, Any] | None):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._attrs = attrs
        self._exit_attrs: dict[str, Any] | None = None

    def set(self, **attrs: Any) -> "_SpanCtx":
        """Attach result attributes, recorded on the span's E event."""
        if self._exit_attrs is None:
            self._exit_attrs = attrs
        else:
            self._exit_attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        self._tracer._emit("B", self._name, self._cat,
                           time.perf_counter(), None,
                           threading.get_ident(), None, self._attrs)
        return self

    def __exit__(self, *exc: Any) -> None:
        self._tracer._emit("E", self._name, self._cat,
                           time.perf_counter(), None,
                           threading.get_ident(), None, self._exit_attrs)


class _Token:
    """Handle for an explicit cross-thread begin/end span."""

    __slots__ = ("name", "cat", "ts", "tid", "attrs")

    def __init__(self, name: str, cat: str, ts: float, tid: int,
                 attrs: dict[str, Any] | None):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.tid = tid
        self.attrs = attrs


class Tracer:
    """Thread-safe bounded-ring span recorder (the flight recorder).

    ``capacity`` bounds the event ring: when full, the **oldest**
    events are evicted (``dropped`` counts them) and recording never
    blocks.  ``enabled=False`` makes every recording method a cheap
    no-op — the object can stay wired into an engine at zero cost and
    be flipped on later.

    >>> tr = Tracer(capacity=128)
    >>> with tr.span("work", cat="demo", n=3) as sp:
    ...     _ = sp.set(result="ok")
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
        self._threads: dict[int, str] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._next_id = 0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _emit(self, ph: str, name: str, cat: str, ts: float,
              dur: float | None, tid: int, aid: int | None,
              args: dict[str, Any] | None) -> None:
        with self._lock:
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(Event(ph, name, cat, ts, dur, tid, aid,
                                      args, self._seq))
            self._seq += 1

    def span(self, name: str, cat: str = "span", **attrs: Any):
        """Thread-scoped duration span as a ``with`` context."""
        if not self.enabled:
            return _NOOP
        return _SpanCtx(self, name, cat, attrs or None)

    def begin(self, name: str, cat: str = "span",
              **attrs: Any) -> _Token | None:
        """Open an explicit span; :meth:`end` may run on ANY thread.

        Returns an opaque token (``None`` when disabled — ``end``
        accepts it).  The span is recorded as a single complete event
        at ``end`` time, attributed to the *beginning* thread.
        """
        if not self.enabled:
            return None
        return _Token(name, cat, time.perf_counter(),
                      threading.get_ident(), attrs or None)

    def end(self, token: _Token | None, **attrs: Any) -> None:
        """Close an explicit span opened by :meth:`begin`."""
        if token is None or not self.enabled:
            return
        if attrs:
            merged = dict(token.attrs or {})
            merged.update(attrs)
        else:
            merged = token.attrs
        now = time.perf_counter()
        self._emit("X", token.name, token.cat, token.ts,
                   max(0.0, now - token.ts), token.tid, None, merged)

    def complete(self, name: str, ts: float, dur: float,
                 cat: str = "span", tid: int | None = None,
                 **attrs: Any) -> None:
        """Record a retroactive complete (``X``) span from timestamps."""
        if not self.enabled:
            return
        self._emit("X", name, cat, ts, max(0.0, dur),
                   tid if tid is not None else threading.get_ident(),
                   None, attrs or None)

    def async_event(self, name: str, ph: str, aid: int,
                    ts: float | None = None, cat: str = "async",
                    **attrs: Any) -> None:
        """Record one async (``b``/``e``) event keyed by ``aid``.

        Async spans tie events on different threads (or emitted
        retroactively) into one timeline track — the engine uses the
        request's trace id as ``aid`` so every phase of one request
        lands on one Perfetto row.
        """
        if not self.enabled:
            return
        if ph not in ("b", "e"):
            raise ValueError(f"async phase must be 'b' or 'e', got {ph!r}")
        self._emit(ph, name, cat,
                   ts if ts is not None else time.perf_counter(),
                   None, threading.get_ident(), aid, attrs or None)

    def async_span(self, name: str, aid: int, t0: float, t1: float,
                   cat: str = "async", **attrs: Any) -> None:
        """Record a retroactive async span ``[t0, t1]`` in one call."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        self._emit("b", name, cat, t0, None, tid, aid, attrs or None)
        self._emit("e", name, cat, max(t0, t1), None, tid, aid, None)

    def instant(self, name: str, cat: str = "span", **attrs: Any) -> None:
        """Record a zero-duration instant event."""
        if not self.enabled:
            return
        self._emit("i", name, cat, time.perf_counter(), None,
                   threading.get_ident(), None, attrs or None)

    def counter(self, name: str, value: float, cat: str = "metric") -> None:
        """Record a counter sample (rendered as a track by Perfetto)."""
        if not self.enabled:
            return
        self._emit("C", name, cat, time.perf_counter(), None,
                   threading.get_ident(), None, {"value": value})

    def new_id(self) -> int:
        """Allocate a fresh trace id (per-request correlation key)."""
        with self._lock:
            self._next_id += 1
            return self._next_id

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    def events(self) -> list[Event]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def thread_names(self) -> dict[int, str]:
        with self._lock:
            return dict(self._threads)

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        # without this, __len__ makes an *empty* tracer falsy, so
        # `tracer or default` silently discards a live recorder
        return True

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


# ----------------------------------------------------------------------
# the process-global tracer ($REPRO_TRACE)
# ----------------------------------------------------------------------
_GLOBAL: Tracer | None = None
_ENV_CHECKED = False


def install(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) the process-global tracer.

    Components that resolve their ``trace`` argument through
    :func:`resolve_tracer` (the serving engine, ``compile_graph``)
    pick it up automatically, so a whole run is traced without
    threading a tracer through each call site.
    """
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else Tracer()
    return _GLOBAL


def uninstall() -> None:
    global _GLOBAL, _ENV_CHECKED
    _GLOBAL = None
    _ENV_CHECKED = True          # do not resurrect from the env var


def get_tracer() -> Tracer | None:
    """The installed global tracer, creating one if ``$REPRO_TRACE`` asks.

    When ``REPRO_TRACE`` names a ``.json`` path, the trace is exported
    there automatically at interpreter exit (flight-recorder dump).
    """
    global _GLOBAL, _ENV_CHECKED
    if _GLOBAL is not None:
        return _GLOBAL
    if _ENV_CHECKED:
        return None
    _ENV_CHECKED = True
    val = os.environ.get(TRACE_ENV, "").strip()
    if not val or val.lower() in ("0", "false", "off"):
        return None
    _GLOBAL = Tracer()
    if val.lower() not in ("1", "true", "on", "yes"):
        import atexit

        def _dump(path: str = val, tracer: Tracer = _GLOBAL) -> None:
            from repro_torch.obs.export import export_chrome_trace
            try:
                export_chrome_trace(tracer, path)
            except OSError:  # pragma: no cover - exit-time best effort
                pass

        atexit.register(_dump)
    return _GLOBAL


def resolve_tracer(trace: Any) -> Tracer | None:
    """Normalize a user-facing ``trace=`` argument into a tracer.

    ``None`` consults the process-global tracer (``install`` /
    ``$REPRO_TRACE``) so tracing can be switched on for a whole run
    without touching call sites; ``False`` opts a component out even
    then; ``True`` builds a private enabled tracer; a :class:`Tracer`
    passes through (disabled tracers resolve to ``None`` so guarded
    hot paths skip even the no-op calls).
    """
    if trace is None:
        trace = get_tracer()
    elif trace is True:
        trace = Tracer()
    elif trace is False:
        return None
    if trace is None:
        return None
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
