"""The device trace of a traced run, read into plain numbers.

``Trace`` wraps ``torch.profiler`` (CPU and CUDA activities) over a
steady stretch of the window, opened and closed after a synchronize
and marked by a ``bench.window`` range, and reduces the raw events to:

- ``device``: every kernel, copy and fill on the card, as (name, start,
  end) in seconds;
- ``host``: every host range (name, start, end, depth order kept), to
  name what the host was doing during a gap;
- ``window``: the marked range's (start, end);
- ``backward_s``: device seconds under the autograd nodes whose names
  are asked for (the plain backwards of the kernels' Functions).
"""
from __future__ import annotations

import time
from typing import Iterable


def _ns(ev, what: str) -> int:
    for name in (f"{what}_ns", f"{what}_us"):
        fn = getattr(ev, name, None)
        if fn is not None:
            v = fn()
            return int(v) if name.endswith("_ns") else int(v * 1000)
    raise AttributeError(what)


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_annotation(ev) -> bool:
    """A host range mirrored on the device's timeline (a record_function
    span), which is no device operation."""
    fn = getattr(ev, "is_user_annotation", None)
    return bool(fn and fn()) or ev.name().startswith(("bench.",
                                                      "ProfilerStep"))


class Trace:
    """``with Trace(torch, sync) as tr: ...``; then ``tr.device``,
    ``tr.host``, ``tr.window``, ``tr.window_s`` (host clock)."""

    def __init__(self, torch, sync, backward_nodes: Iterable[str] = ()):
        self.torch, self.sync = torch, sync
        self.backward_nodes = tuple(backward_nodes)
        self.device: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.window: tuple[float, float] = (0.0, 0.0)
        self.window_s = 0.0
        self.backward_s: dict[str, float] = {}

    @staticmethod
    def warm(torch, sync) -> None:
        """Start and stop the profiler once over a small operation: its
        first start sets up the device tracing (seconds, in a process
        that holds a large cache), which set-up pays, not the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        sync()
        with profile(activities=acts):
            x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                           else "cpu")
            (x + x).sum()
            sync()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function("bench.window")
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        events = list(self._prof.profiler.kineto_results.events())
        t_min = None
        for ev in events:
            try:
                start = _ns(ev, "start")
                dur = _ns(ev, "duration")
            except AttributeError:
                continue
            t_min = start if t_min is None else min(t_min, start)
            row = (ev.name(), start, start + dur)
            if not _is_device(ev):
                self.host.append(row)
            elif not _is_annotation(ev):
                self.device.append(row)
        t_min = t_min or 0

        def sec(rows):
            return [(n, (a - t_min) * 1e-9, (b - t_min) * 1e-9)
                    for n, a, b in rows]
        self.device = sorted(sec(self.device), key=lambda r: r[1])
        self.host = sec(self.host)
        marks = [r for r in self.host if r[0] == "bench.window"]
        if marks:
            self.window = (marks[0][1], marks[0][2])
        elif self.device:
            self.window = (self.device[0][1], self.device[-1][2])
        if self.backward_nodes:
            self.backward_s = self._backward_seconds()

    def _backward_seconds(self) -> dict[str, float]:
        """Device seconds of the kernels launched under each autograd
        node named in ``backward_nodes``, counting nested matches once."""
        out = {n: 0.0 for n in self.backward_nodes}
        for evt in self._prof.events():
            name = evt.name
            node = next((n for n in self.backward_nodes if n in name), None)
            if node is None:
                continue
            parent, nested = evt.cpu_parent, False
            while parent is not None:
                if any(n in parent.name for n in self.backward_nodes):
                    nested = True
                    break
                parent = parent.cpu_parent
            if nested:
                continue
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = getattr(evt, "cuda_time_total", 0.0)
            out[node] += float(total) * 1e-6
        return out


def busy_s(device: list, window: tuple[float, float]) -> float:
    """Seconds of ``window`` in which some device operation ran (the
    union of the intervals)."""
    lo, hi = window
    busy, end = 0.0, lo
    for _, a, b in device:
        a, b = max(a, lo, end), min(b, hi)
        if b > a:
            busy += b - a
        end = max(end, min(b, hi))
    return busy


def gaps(device: list, window: tuple[float, float]
         ) -> list[tuple[float, float]]:
    """The idle intervals of ``window`` between device operations."""
    out, end = [], window[0]
    for _, a, b in device:
        if a > end:
            out.append((end, min(a, window[1])))
        end = max(end, b)
    if window[1] > end:
        out.append((end, window[1]))
    return [(a, b) for a, b in out if b > a]


def host_at(host: list, t: float) -> str:
    """What the host was doing at ``t``: the outermost and the innermost
    host range around it (``bench.window`` aside), as 'outer > inner'."""
    around = [(b - a, n) for n, a, b in host
              if a <= t <= b and n != "bench.window"]
    if not around:
        return "host: no range"
    around.sort()
    inner, outer = around[0][1], around[-1][1]
    return outer if inner == outer else f"{outer} > {inner}"


def breakdown(device: list, host: list, window: tuple[float, float],
              n: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each with what the host was doing; at most ``n`` each."""
    by_name: dict[str, float] = {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(gaps(device, window), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[host_at(host, (a + b) / 2)[:160], b - a]
                          for a, b in idle]}
