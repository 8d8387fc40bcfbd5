"""Chrome trace-event export: turn a :class:`Tracer` ring into JSON.

Copy of :mod:`repro.obs.export`.

The output follows the `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON-object flavor (``{"traceEvents": [...]}``) that both
``chrome://tracing`` and `Perfetto <https://ui.perfetto.dev>`_ load
directly.  Timestamps are emitted in **microseconds on the Unix
epoch**, the timebase ``torch.profiler`` stamps its events with (its
own Chrome trace writes them less its ``baseTimeNanoseconds``), so a
``$REPRO_TRACE`` dump lines up with a profiler trace of the same run.
The ring's ``perf_counter`` stamps are mapped there linearly between
two ``(perf_counter_ns, time_ns)`` anchors, the tracer's from its
creation and one taken at export; both go into the payload's
``otherData.clock``.

Because the recorder is a bounded ring that evicts oldest-first, the
snapshot can open mid-span: an ``E`` whose ``B`` was evicted, or a
``B`` whose ``E`` is still pending at export time.  ``to_chrome_events``
*sanitizes* the stream — orphan ``E`` events are dropped and dangling
``B`` events are closed at the trace's end — so the export always
passes :func:`validate_chrome_trace`.
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.obs.tracer import Event, Tracer, clock_anchor

__all__ = ["to_chrome_events", "export_chrome_trace",
           "validate_chrome_trace", "load_chrome_trace"]

#: single-process traces: one pid for everything
_PID = 1


class _EpochClock:
    """perf_counter seconds -> microseconds on the Unix epoch, linear
    between two ``(perf_counter_ns, time_ns)`` anchors (offset only
    where the wall clock did not advance between them, so the map never
    reorders events)."""

    def __init__(self, first: tuple[int, int], last: tuple[int, int]):
        (p0, w0), (p1, w1) = first, last
        self.scale = (w1 - w0) / (p1 - p0) if p1 > p0 and w1 > w0 else 1.0
        self.p0 = p0 * 1e-9
        self.w0 = w0 * 1e-3

    def us(self, ts: float) -> float:
        return round(self.w0 + (ts - self.p0) * 1e6 * self.scale, 3)

    def dur_us(self, dur: float) -> float:
        return round(dur * 1e6 * self.scale, 3)


def to_chrome_events(tracer: Tracer, anchor: tuple[int, int] | None = None
                     ) -> list[dict[str, Any]]:
    """Render the tracer's ring as a list of Chrome trace events.

    ``anchor`` is the export's ``(perf_counter_ns, time_ns)`` pair
    (:func:`~repro_torch.obs.tracer.clock_anchor`, taken now if None);
    with the tracer's own it maps every timestamp onto the Unix epoch,
    in microseconds.

    Events are ordered by ``(ts, seq)`` — the ring appends under a
    lock, but retroactive emissions (async request timelines, cross-
    thread ``X`` spans) carry captured timestamps older than their
    insertion order, and viewers require per-thread monotonic time.
    Sanitization then repairs ring-eviction damage (orphan ``E``,
    dangling ``B``) before anything is serialized.
    """
    events = sorted(tracer.events(), key=lambda e: (e.ts, e.seq))
    clock = _EpochClock(tracer.anchor, anchor or clock_anchor())
    out: list[dict[str, Any]] = []
    for tid, name in sorted(tracer.thread_names().items()):
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "args": {"name": name}})
    if not events:
        return out
    t_end = max(e.ts + (e.dur or 0.0) for e in events)
    # depth of open B spans per tid, for eviction repair
    open_stacks: dict[int, list[Event]] = {}
    skipped_e: list[Event] = []
    for e in events:
        if e.ph == "B":
            open_stacks.setdefault(e.tid, []).append(e)
        elif e.ph == "E":
            stack = open_stacks.get(e.tid)
            if not stack:
                # its B was evicted from the ring: drop the orphan E
                skipped_e.append(e)
                continue
            stack.pop()
        rec: dict[str, Any] = {"ph": e.ph, "name": e.name, "cat": e.cat,
                               "ts": clock.us(e.ts), "pid": _PID,
                               "tid": e.tid}
        if e.ph == "X":
            rec["dur"] = clock.dur_us(e.dur or 0.0)
        if e.aid is not None:
            rec["id"] = str(e.aid)
        if e.ph == "i":
            rec["s"] = "t"
        if e.ph == "C":
            rec["args"] = dict(e.args or {"value": 0})
        elif e.args:
            rec["args"] = dict(e.args)
        out.append(rec)
    # close spans still open at snapshot time (or whose E was evicted)
    for tid, stack in open_stacks.items():
        for e in reversed(stack):
            out.append({"ph": "E", "name": e.name, "cat": e.cat,
                        "ts": clock.us(t_end), "pid": _PID, "tid": tid})
    return out


def export_chrome_trace(tracer: Tracer, path: str) -> dict[str, Any]:
    """Write the tracer's ring to ``path`` as a Chrome trace JSON.

    Returns the payload that was written (handy for tests).  The
    payload carries ``displayTimeUnit: "ms"`` and a small metadata
    block recording how many events the ring dropped and the two clock
    anchors (``clock``: ``created`` and ``exported``, each
    ``[perf_counter_ns, time_ns]``).
    """
    anchor = clock_anchor()
    payload = {
        "traceEvents": to_chrome_events(tracer, anchor),
        "displayTimeUnit": "ms",
        "otherData": {"recorder": "repro_torch.obs", "dropped": tracer.dropped,
                      "clock": {"created": list(tracer.anchor),
                                "exported": list(anchor)}},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def load_chrome_trace(path: str) -> dict[str, Any]:
    """Load a trace JSON written by :func:`export_chrome_trace`."""
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(payload: dict[str, Any]) -> dict[str, Any]:
    """Check a trace payload against the trace-event schema rules.

    Raises ``ValueError`` on the first violation; returns a summary
    dict (event/span/async counts) on success.  Checked invariants —
    the ones Perfetto's importer actually relies on:

    - payload is an object with a ``traceEvents`` list of objects,
      each with string ``ph``/``name`` and numeric ``ts`` (except
      ``M`` metadata, which has no timestamp requirement);
    - per ``(pid, tid)``, timestamps are monotonically non-decreasing;
    - per ``(pid, tid)``, ``B``/``E`` events match like parentheses
      (same name on pop, nothing left open);
    - async ``b``/``e`` events balance per ``(cat, id, name)`` key;
    - ``X`` events carry a non-negative ``dur``.
    """
    if not isinstance(payload, dict):
        raise ValueError(f"trace payload must be an object, got "
                         f"{type(payload).__name__}")
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace payload has no traceEvents list")
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list[str]] = {}
    async_open: dict[tuple, int] = {}
    n_spans = n_async = n_x = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = e.get("ph")
        name = e.get("name")
        if not isinstance(ph, str) or not isinstance(name, str):
            raise ValueError(f"traceEvents[{i}] missing ph/name strings")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            raise ValueError(f"traceEvents[{i}] ({ph} {name!r}) has no "
                             f"numeric ts")
        key = (e.get("pid"), e.get("tid"))
        prev = last_ts.get(key)
        if prev is not None and ts < prev:
            raise ValueError(
                f"traceEvents[{i}] ({ph} {name!r}): ts {ts} goes "
                f"backwards on tid {key[1]} (prev {prev})")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(name)
            n_spans += 1
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(
                    f"traceEvents[{i}]: E {name!r} on tid {key[1]} "
                    f"with no open B")
            top = stack.pop()
            if top != name:
                raise ValueError(
                    f"traceEvents[{i}]: E {name!r} closes B {top!r} "
                    f"on tid {key[1]} (mismatched pair)")
        elif ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"traceEvents[{i}]: X {name!r} needs dur >= 0, "
                    f"got {dur!r}")
            n_x += 1
        elif ph == "b":
            akey = (e.get("cat"), e.get("id"), name)
            async_open[akey] = async_open.get(akey, 0) + 1
            n_async += 1
        elif ph == "e":
            akey = (e.get("cat"), e.get("id"), name)
            if async_open.get(akey, 0) <= 0:
                raise ValueError(
                    f"traceEvents[{i}]: async e {name!r} id="
                    f"{e.get('id')!r} with no open b")
            async_open[akey] -= 1
    for key, stack in stacks.items():
        if stack:
            raise ValueError(
                f"unclosed B span(s) {stack!r} on tid {key[1]}")
    dangling = {k: v for k, v in async_open.items() if v}
    if dangling:
        raise ValueError(f"unbalanced async spans: {dangling!r}")
    return {"events": len(events), "spans": n_spans,
            "async_spans": n_async, "complete": n_x,
            "threads": len(last_ts)}
