"""The readers of the program's spans (``bench/harness/spans.py`` and the
metrics that use it): nothing without a CUDA trace, and the expected
numbers on profiles built by hand, with and without the events'
activity types (torch versions differ there)."""
from __future__ import annotations

import types

import pytest
import torch

from bench.harness import spans as S
from bench.harness.cell import reader
from bench.harness.profile import Trace
from bench.harness.record import Record
from bench.harness.runner import run_cell
from bench_fixtures import smoke_cell

NEW = ("prefill_idle_share.gen", "replay_ms.gen", "forward_ms.train",
       "backward_ms.train", "optimizer_ms.train")


class Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, end, device=False, corr=0, linked=0,
                 annotation=False, activity=None):
        self._v = (name, start, end, device, corr, linked, annotation)
        if activity is not None:
            self.activity_type = lambda: activity

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _record(events) -> Record:
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))
    trace = types.SimpleNamespace(_prof=prof, window=(0.0, 0.0), device=[])
    return Record(sizes={}, traffic={}, trace=trace)


def _span(name, a, b):
    return Ev(name, a, b, annotation=True, activity="user_annotation")


def _launch(at, corr, typed):
    return Ev("cudaLaunchKernel", at, at + 2_000, corr=corr,
              activity="cuda_runtime" if typed else None)


def _kernel(a, b, corr, linked=0, typed=True):
    return Ev("kernel", a, b, device=True, corr=corr, linked=linked,
              activity="kernel" if typed else None)


def _gen_events(typed: bool) -> list:
    """1 ms window: two replays (two kernels, then one), one prefill under
    its admission (a kernel; idle 20 us before it and 70 us after it), a
    device-side mirror of the prefill's range, which is no operation."""
    k = dict(typed=typed)
    return [
        _span("bench.window", 0, 1_000_000),
        _span("compiled.replay", 100_000, 110_000),
        Ev("cudaGraphLaunch", 105_000, 108_000, corr=1,
           activity="cuda_runtime" if typed else None),
        _kernel(120_000, 200_000, 1, **k), _kernel(200_000, 260_000, 1, **k),
        _span("batcher.admit", 300_000, 480_000),
        _span("batcher.prefill", 310_000, 470_000),
        _launch(320_000, 3, typed), _kernel(330_000, 400_000, 3, **k),
        Ev("batcher.prefill", 400_000, 470_000, device=True,
           annotation=True, activity="gpu_user_annotation"),
        _span("compiled.replay", 500_000, 510_000),
        Ev("cudaGraphLaunch", 505_000, 508_000, corr=2,
           activity="cuda_runtime" if typed else None),
        _kernel(520_000, 600_000, 2, **k),
    ]


def _train_events(typed: bool) -> list:
    """Two 1 ms steps: the forward launches one kernel, the backward one
    from the autograd engine's thread and a copy tied only to its host
    operation, the optimizer one; a kernel launched outside every span."""
    out = [_span("bench.window", 0, 2_000_000)]
    for s in (0, 1):
        o, c = s * 1_000_000, 10 * s
        out += [
            _span("train.forward", o, o + 300_000),
            _launch(o + 10_000, c + 1, typed),
            _kernel(o + 20_000, o + 250_000, c + 1, typed=typed),
            _span("train.backward", o + 300_000, o + 800_000),
            _launch(o + 400_000, c + 2, typed),           # another thread
            _kernel(o + 410_000, o + 700_000, c + 2, typed=typed),
            Ev("aten::copy_", o + 720_000, o + 725_000, corr=1000 + s,
               activity="cpu_op" if typed else None),
            _kernel(o + 730_000, o + 760_000, 5000 + s, linked=1000 + s,
                    typed=typed),
            _span("train.optimizer", o + 800_000, o + 900_000),
            _launch(o + 810_000, c + 3, typed),
            _kernel(o + 820_000, o + 880_000, c + 3, typed=typed),
            _launch(o + 950_000, c + 4, typed),
            _kernel(o + 960_000, o + 990_000, c + 4, typed=typed),
        ]
    return out


@pytest.mark.parametrize("typed", [True, False])
def test_the_gen_readers_on_a_profile_built_by_hand(typed):
    rec = _record(_gen_events(typed))
    assert reader("replay_ms.gen")(rec) == pytest.approx(0.11)
    # idle in the window: 120 + 70 + 120 + 400 us; under the prefill
    # 20 + 70 us of it, the 50 us before the prefill not
    assert reader("prefill_idle_share.gen")(rec) == pytest.approx(9.0)
    for m in ("forward_ms.train", "backward_ms.train", "optimizer_ms.train"):
        assert reader(m)(rec) is None


@pytest.mark.parametrize("typed", [True, False])
def test_the_train_readers_on_a_profile_built_by_hand(typed):
    rec = _record(_train_events(typed))
    assert reader("forward_ms.train")(rec) == pytest.approx(0.23)
    assert reader("backward_ms.train")(rec) == pytest.approx(0.32)
    assert reader("optimizer_ms.train")(rec) == pytest.approx(0.06)
    assert reader("replay_ms.gen")(rec) is None
    assert reader("prefill_idle_share.gen")(rec) is None


def test_a_profile_without_the_spans_reads_nothing():
    """The parent of a program's spans: the same operations, no ranges."""
    rec = _record([e for e in _gen_events(True) + _train_events(True)
                   if not e.name().startswith(("batcher.", "compiled.",
                                               "train."))])
    for m in NEW:
        assert reader(m)(rec) is None, m


@pytest.mark.parametrize("mix", ["gen", "train"])
def test_the_readers_find_nothing_in_a_cpu_trace(mix, monkeypatch):
    """A profile of the CPU has no device operation: every new reader
    returns None, also when the program's spans are in it."""
    seen = []

    class Seen(S.Spans):
        def __init__(self, events):
            events = list(events)
            seen.extend(e.name() for e in events)
            super().__init__(events)
    monkeypatch.setattr(S, "Spans", Seen)
    line = run_cell(smoke_cell("granite", mix), 2**31 + 9, 0.5, True,
                    torch.device("cpu"), 0.0)
    assert not set(NEW) & set(line["metrics"])
    want = {"gen": "batcher.decode", "train": "train.backward"}[mix]
    assert want in seen


def test_a_trace_of_the_cpu_alone():
    def sync():
        pass
    with Trace(torch, sync) as tr:
        torch.ones(4).sum()
    rec = Record(sizes={}, traffic={}, trace=tr)
    for m in NEW:
        assert reader(m)(rec) is None, m
