"""The model's own layer spans in the profiled stretch.

``bench/harness/spans.py`` reads the spans of the batcher, the compiled
step and the train step (its ``PREFIXES``); the spans a model layer
opens (``moe.layer`` around each dropless MoE layer, ``moe.dispatch``
inside it, ``models/layers.py``) are read here the same way: each
device operation tied to its launch by the profiler's correlation id,
and the launch to the spans around it in host time.  A captured decode
step opens them at its capture only, so in a window they are the eager
prefills' spans.
"""
from __future__ import annotations

from bench.harness import profile as P
from bench.harness import spans as S

#: the span names read: the program's steps and the model's layers
PREFIXES = S.PREFIXES + ("moe.",)


class LayerSpans(S.Spans):
    """:class:`bench.harness.spans.Spans` over :data:`PREFIXES`."""

    def __init__(self, events):
        self.window = None
        self.device = []
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
            corr = S._corr(ev, "correlation_id")
            if corr:
                (runtime if S._is_runtime(ev) else ops)[corr] = start
        for ev, a, b in pending:
            t = runtime.get(S._corr(ev, "correlation_id"))
            if t is None:
                t = ops.get(S._corr(ev, "linked_correlation_id"))
            self.device.append((a, b, t))
        self.device.sort()
        if self.window is None and self.device:
            self.window = (self.device[0][0],
                           max(b for _, b, _ in self.device))
        self.spans = {n: S._union(iv) for n, iv in raw.items()}
        self.starts = {n: sorted(a for a, _ in iv) for n, iv in raw.items()}


def of(rec) -> LayerSpans | None:
    """The record's profile read for the layer spans, or None where it
    has no device operation (kept on the trace, as ``spans.of`` keeps
    its reading)."""
    trace = rec.trace
    if trace is None:
        return None
    if not hasattr(trace, "_layer_spans"):
        prof = getattr(trace, "_prof", None)
        s = (None if prof is None
             else LayerSpans(prof.profiler.kineto_results.events()))
        trace._layer_spans = s if s is not None and s.device and s.window \
            else None
    return trace._layer_spans


def device_ms_per(rec, name: str, per: str) -> float | None:
    """Device ms of the operations launched inside spans ``name``, per
    span ``per`` begun in the window."""
    s = of(rec)
    if s is None:
        return None
    n, ns = s.count(per), s.device_ns(name)
    return 1e-6 * ns / n if n and ns else None
