"""The port's LM spans (``repro_torch.obs.tracer`` inside the batcher, the
compiled step and the train step), on the CPU at the smoke sizes.

With a :class:`Tracer` installed, a served request's ``queued`` ->
``prefill`` -> ``decode`` timeline is one contiguous async track whose
queue wait is its prefill's start less its submission; each
``batcher.prefill`` nests under a ``batcher.admit``; ``batcher.active``
and ``batcher.queued`` are sampled once a step; a train step records
``train.forward``, ``train.backward`` and ``train.optimizer`` in that
order; the compiled step's phases (a stand-in graph for the card's) each
open their span.  Each takes the process-global tracer.  With neither
recorder on, nothing holds recorder state and no profiler range
is entered.  Under ``torch.profiler`` with no tracer, the profiler's host
ranges carry every span name; and the export puts a ring span within
1 ms of its profiler range, on the profiler's clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import tracer as tmod  # noqa: E402
from repro_torch.obs import (Tracer, export_chrome_trace,  # noqa: E402
                             to_chrome_events, validate_chrome_trace)
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import compiled_step as CS  # noqa: E402
from repro_torch.runtime.batcher import (ContinuousBatcher,  # noqa: E402
                                         Request)
from repro_torch.runtime.steps import make_train_step  # noqa: E402

BATCHER_SPANS = {"batcher.admit", "batcher.prefill", "batcher.decode",
                 "batcher.sample", "batcher.retire"}
COMPILED_SPANS = {"compiled.warm_up", "compiled.capture", "compiled.replay",
                  "compiled.eager"}
TRAIN_SPANS = {"train.forward", "train.backward", "train.optimizer"}


@pytest.fixture(autouse=True)
def _no_global_tracer():
    """Each test starts with no process-global tracer, whatever
    ``$REPRO_TRACE`` says, and leaves none behind."""
    tmod.uninstall()
    yield
    tmod.uninstall()


@pytest.fixture(scope="module")
def granite():
    cfg = tconfigs.get_smoke("granite_3_2b")
    return cfg, TM.init(cfg, 3, device="cpu")


def _requests(cfg, n: int, seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 4 + i)
                    .astype(np.int32), max_new_tokens=3 + i % 3)
            for i in range(n)]


def _serve(granite, n: int = 5) -> ContinuousBatcher:
    cfg, params = granite
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu")
    for r in _requests(cfg, n):
        b.submit(r)
    b.run_to_completion()
    assert len(b.finished) == n
    return b


def _train(microbatches: int = 1):
    cfg = dataclasses.replace(tconfigs.get_smoke("granite_3_2b"),
                              microbatches=microbatches)
    params = TM.init(cfg, 5, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(cfg, AdamWConfig())
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 9), generator=g)
    step(state, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    return step


# ----------------------------------------------------------------------
# the ring, with a tracer installed
# ----------------------------------------------------------------------
def test_every_request_has_one_contiguous_timeline(granite, tmp_path):
    tr = tmod.install(Tracer())
    t0 = time.perf_counter()
    b = _serve(granite)
    req = [e for e in tr.events() if e.cat == "request"]
    aids = sorted({e.aid for e in req})
    assert len(aids) == len(b.finished)
    rids = set()
    for aid in aids:
        evs = [e for e in req if e.aid == aid]
        begin = {e.name: e for e in evs if e.ph == "b"}
        end = {e.name: e for e in evs if e.ph == "e"}
        assert set(begin) == set(end) == {"request", "queued", "prefill",
                                          "decode"}
        assert t0 <= begin["request"].ts == begin["queued"].ts
        assert end["queued"].ts == begin["prefill"].ts
        assert end["prefill"].ts == begin["decode"].ts
        assert end["decode"].ts == end["request"].ts
        assert begin["queued"].args["wait_ms"] == pytest.approx(
            (begin["prefill"].ts - begin["request"].ts) * 1e3, abs=1e-9)
        rids.add(begin["request"].args["rid"])
    assert rids == {r.rid for r in b.finished}
    assert b._timeline == {}          # every mark taken back at retirement
    validate_chrome_trace(export_chrome_trace(tr, str(tmp_path / "s.json")))


def test_each_prefill_nests_under_an_admission(granite):
    tr = tmod.install(Tracer())
    _serve(granite)
    stack, prefills = [], []
    for e in tr.events():
        if e.ph == "B" and e.name.startswith("batcher."):
            if e.name == "batcher.prefill":
                assert stack == ["batcher.admit"], stack
                prefills.append(e.args)
            stack.append(e.name)
        elif e.ph == "E" and e.name.startswith("batcher."):
            assert stack.pop() == e.name
    assert not stack
    cfg = granite[0]
    assert prefills == [{"rid": r.rid, "tokens": len(r.prompt)}
                        for r in _requests(cfg, 5)]


def test_active_and_queued_are_sampled_once_a_step(granite):
    cfg, params = granite
    tr = tmod.install(Tracer())
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu")
    for r in _requests(cfg, 4):
        b.submit(r)
    seen, produced = [], []
    while b.queue or b.active:
        n = len(tr.events())
        produced.append(b.step())
        new = tr.events()[n:]
        active = [e.args["value"] for e in new if e.name == "batcher.active"]
        queued = [e.args["value"] for e in new if e.name == "batcher.queued"]
        assert len(active) == len(queued) == 1
        seen.append((active[0], queued[0]))
    assert seen[0] == (2, 2) and seen[-1][1] == 0
    assert sum(produced) == sum(len(r.tokens) - 1 for r in b.finished)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_train_step_records_forward_backward_optimizer(microbatches):
    tr = tmod.install(Tracer())
    step = _train(microbatches)
    assert step.tracer is tr
    spans = [e.name for e in tr.events() if e.ph == "B"]
    assert spans == (["train.forward", "train.backward"] * microbatches
                     + ["train.optimizer"])
    assert [e for e in tr.events() if e.ph == "C"] == []


class _StandInGraph:
    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs

    def replay(self):
        self.fn(*self.inputs)


def _counted(x):
    _counted.launches += 1
    _counted.one_launches += 1
    return x * 2


_counted.launches = _counted.one_launches = 0


class _StandInStep(CS.CompiledStep):
    """``CompiledStep`` with the CUDA calls replaced by a stand-in graph
    that reruns the step at replay."""

    def __init__(self, fn):
        super().__init__(fn, device="cpu", counters=(_counted,))
        self.graphed = True

    def _warm_up(self):
        return CS._copies(self.fn(*self._inputs))

    def _record(self):
        return _StandInGraph(self.fn, self._inputs), self.fn(*self._inputs)


def test_the_compiled_step_names_each_phase():
    tr = tmod.install(Tracer())
    step = _StandInStep(lambda x: (_counted(x), _counted(x + 1)))
    for _ in range(4):
        step(torch.ones(3))
    spans = [e.name for e in tr.events() if e.ph == "B"]
    assert spans == ["compiled.warm_up", "compiled.capture",
                     "compiled.replay", "compiled.replay", "compiled.replay"]
    assert step.step_launches["_counted"] == 2
    eager = CS.CompiledStep(lambda x: x + 1, device="cpu", counters=())
    eager(torch.ones(2))
    assert [e.name for e in tr.events() if e.ph == "B"][-1] == \
        "compiled.eager"


# ----------------------------------------------------------------------
# neither recorder on
# ----------------------------------------------------------------------
def test_with_no_recorder_nothing_is_held_or_recorded(granite, monkeypatch):
    entered = []
    monkeypatch.setattr(tmod, "_mirror_enter", entered.append)
    assert not tmod.profiling()
    b = _serve(granite)
    assert b.tracer is None and b._timeline is None
    assert b.compiled.tracer is None
    step = _train()
    assert step.tracer is None
    graph = _StandInStep(lambda x: _counted(x))
    for _ in range(3):
        graph(torch.ones(2))
    assert graph.tracer is None
    assert tmod.get_tracer() is None and entered == []


# ----------------------------------------------------------------------
# the profiler mirror
# ----------------------------------------------------------------------
def _ranges(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and "CPU" in str(e.device_type())]


def test_profiler_ranges_carry_every_span_with_no_tracer(granite):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tmod.profiling()
        _serve(granite, n=3)
        _train()
        graph = _StandInStep(lambda x: _counted(x))
        for _ in range(3):
            graph(torch.ones(2))
    assert not tmod.profiling()
    names = {e.name() for e in _ranges(prof)}
    assert BATCHER_SPANS | COMPILED_SPANS | TRAIN_SPANS <= names


def test_a_disabled_tracer_and_a_cross_thread_span_mirror():
    tr, off = Tracer(), Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off.span("off.span"):
            pass
        tok = tr.begin("cross.span")
        th = threading.Thread(target=lambda: tr.end(tok))
        th.start()
        th.join()
        off.end(off.begin("off.begin"))
    names = [e.name() for e in _ranges(prof)]
    assert sorted(names) == ["cross.span", "off.begin", "off.span"]
    assert [e.name for e in tr.events()] == ["cross.span"] and not len(off)


def test_the_export_lines_up_with_the_profiler_clock(tmp_path):
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tr.span("clock.probe", i=i):
                time.sleep(0.002)
            time.sleep(0.001)
    payload = export_chrome_trace(tr, str(tmp_path / "c.json"))
    validate_chrome_trace(payload)
    clock = payload["otherData"]["clock"]
    assert clock["created"] == list(tr.anchor)
    assert clock["exported"][0] > clock["created"][0]
    ring = [e for e in payload["traceEvents"] if e["name"] == "clock.probe"]
    mirrored = sorted((e.start_ns(), e.end_ns()) for e in _ranges(prof)
                      if e.name() == "clock.probe")
    assert len(ring) == 2 * len(mirrored) == 10
    for k, (start, end) in enumerate(mirrored):
        b, e = ring[2 * k], ring[2 * k + 1]
        assert (b["ph"], e["ph"]) == ("B", "E")
        assert abs(b["ts"] - start / 1e3) < 1000.0        # microseconds
        assert abs(e["ts"] - end / 1e3) < 1000.0
    # the map is the same at any later export, up to the anchors' drift
    again = [e for e in to_chrome_events(tr) if e["name"] == "clock.probe"]
    assert abs(again[0]["ts"] - ring[0]["ts"]) < 1000.0
