"""The program's own spans in the profiled stretch: the device operations
each one launched, and the device's idle time under it.

While ``torch.profiler`` records, ``repro_torch.obs.tracer`` mirrors each
span of the port (``batcher.*``, ``compiled.*``, ``train.*``) into a
profiler range of the same name.  Here every device operation (kernel,
copy, fill) of a traced run's profile is tied to its launch on the host
through the profiler's correlation id (the runtime call's; else the
host operation's that encloses it), and a launch to the spans whose host
interval holds it, on any thread: the autograd engine launches a
backward's kernels from its own thread while the step's thread waits
inside ``train.backward``.  The raw events come from ``rec.trace._prof``,
since ``Trace`` keeps names and times only.

Every function returns None where the profile holds no device operation
(a run on the CPU) or no span of the name (a program without the spans).
"""
from __future__ import annotations

import bisect

from bench.harness import profile as P

#: the prefixes of the program's span names
PREFIXES = ("batcher.", "compiled.", "train.")
#: the host's runtime and driver calls (the launches), by activity type
#: or, where the profiler's events do not give one, by name
RUNTIME = ("cuda_runtime", "cuda_driver")
RUNTIME_NAMES = ("cuda", "cu")


def _corr(ev, what: str) -> int:
    fn = getattr(ev, what, None)
    return int(fn()) if fn is not None else 0


def _is_runtime(ev) -> bool:
    fn = getattr(ev, "activity_type", None)
    if fn is not None:
        return str(fn()) in RUNTIME
    return ev.name().startswith(RUNTIME_NAMES)


def _union(intervals: list) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(intervals: list, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the sorted disjoint ``intervals`` cover."""
    i = max(bisect.bisect_right(intervals, (lo,)) - 1, 0)
    total = 0
    for a, b in intervals[i:]:
        if a >= hi:
            break
        total += max(0, min(b, hi) - max(a, lo))
    return total


def _holds(intervals: list, t: int) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


class Spans:
    """The profile's device operations, ``(start, end, launch)`` in ns
    (``launch`` None where no correlation names it), its window, and
    each program span's intervals by name, merged across threads."""

    def __init__(self, events):
        self.window: tuple[int, int] | None = None
        self.device: list[tuple[int, int, int | None]] = []
        raw: dict[str, list[tuple[int, int]]] = {}
        runtime: dict[int, int] = {}
        ops: dict[int, int] = {}
        pending = []
        for ev in events:
            try:
                start = P._ns(ev, "start")
                end = start + P._ns(ev, "duration")
            except AttributeError:
                continue
            if P._is_device(ev):
                if not P._is_annotation(ev):
                    pending.append((ev, start, end))
                continue
            name = ev.name()
            if name == "bench.window":
                self.window = (start, end)
            elif name.startswith(PREFIXES):
                raw.setdefault(name, []).append((start, end))
            corr = _corr(ev, "correlation_id")
            if corr:
                (runtime if _is_runtime(ev) else ops)[corr] = start
        for ev, a, b in pending:
            t = runtime.get(_corr(ev, "correlation_id"))
            if t is None:
                t = ops.get(_corr(ev, "linked_correlation_id"))
            self.device.append((a, b, t))
        self.device.sort()
        if self.window is None and self.device:
            self.window = (self.device[0][0],
                           max(b for _, b, _ in self.device))
        self.spans = {n: _union(iv) for n, iv in raw.items()}
        self.starts = {n: sorted(a for a, _ in iv) for n, iv in raw.items()}

    def count(self, name: str) -> int:
        """Spans ``name`` that began inside the window."""
        lo, hi = self.window
        return sum(lo <= a <= hi for a in self.starts.get(name, ()))

    def device_ns(self, name: str) -> int:
        """ns of the window's device operations launched inside a span
        ``name``."""
        spans = self.spans.get(name)
        if not spans:
            return 0
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for a, b, t in self.device
                   if t is not None and b > lo and a < hi
                   and _holds(spans, t))

    def idle_ns_under(self, name: str) -> int:
        """ns of the window with no device operation while the host was
        inside a span ``name``."""
        lo, hi = self.window
        idle, end = [], lo
        for a, b, _ in self.device:
            if a > end:
                idle.append((end, min(a, hi)))
            end = max(end, b)
        if hi > end:
            idle.append((end, hi))
        spans = self.spans.get(name, [])
        return sum(_overlap(spans, a, b) for a, b in idle if b > a)


def _read(trace) -> Spans | None:
    prof = getattr(trace, "_prof", None)
    if prof is None:
        return None
    spans = Spans(prof.profiler.kineto_results.events())
    return spans if spans.device and spans.window else None


def of(rec) -> Spans | None:
    """The record's profile read for the program's spans, or None where
    it has no device operation.  The reading is kept on the trace
    itself, so the readers of one run share one pass over its events
    and it goes with the trace."""
    trace = rec.trace
    if trace is None:
        return None
    if not hasattr(trace, "_program_spans"):
        trace._program_spans = _read(trace)
    return trace._program_spans


def device_ms_per(rec, name: str, per: str) -> float | None:
    """Device ms of the operations launched inside spans ``name``, per
    span ``per`` begun in the window (a replay, a step)."""
    s = of(rec)
    if s is None:
        return None
    n, ns = s.count(per), s.device_ns(name)
    return 1e-6 * ns / n if n and ns else None


def idle_share_under(rec, name: str) -> float | None:
    """The share of the window, in %, with no device operation while the
    host was inside a span ``name``."""
    s = of(rec)
    if s is None or name not in s.spans:
        return None
    lo, hi = s.window
    return 100.0 * s.idle_ns_under(name) / (hi - lo)
