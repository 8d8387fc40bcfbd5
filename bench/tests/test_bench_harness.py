"""The harness: BENCHMARK.json against the contract, the files it names,
the result line's shape, and `correct` against planted faults, on the
CPU at the port's smoke sizes."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from bench.harness.cell import reader
from bench.harness.runner import run_cell
from bench_fixtures import ROOT, smoke_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line_ok(c["why"])
        assert (ROOT / c["file"]).exists() and c["file"].startswith("bench/")
        assert c["reduced"] == []
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and _line_ok(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line_ok(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]]
        for w in m["workloads"]:        # every listed cell reports it
            assert w in moved.get("workloads", CELLS)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    for w in CELLS:
        reports = [m for m in SPEC["end_to_end"] if w in m.get("workloads",
                                                               CELLS)]
        assert len(reports) >= 2
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
        # every kernel roofline's end-to-end metric has an mfu beside it
        for m in SPEC["per_layer"]:
            if "roofline" in m["name"] and w in m["workloads"]:
                assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                           and w in x["workloads"]
                           for x in SPEC["per_layer"]), (w, m["name"])


def test_each_cell_has_its_limits():
    """Every compared number's limit lies between its two readings; a
    number left uncompared says why; each cell compares one at least."""
    for w in CELLS:
        limits = json.loads((ROOT / f"bench/limits/{w}.json").read_text())
        compared = 0
        for name, entry in limits.items():
            if name.startswith("_"):            # where the readings come from
                continue
            if entry["limit"] is None:
                assert entry["why"] and entry["lower"] > 0, (w, name)
                continue
            compared += 1
            assert entry["lower"] < entry["limit"] < entry["upper"], (w, name)
            assert entry["upper"] >= 3 * entry["lower"], (w, name)
        assert compared, w


def test_the_judge():
    from bench.harness.runner import _judge
    lim = {"a": {"limit": 1.0}, "b": {"limit": None, "why": "x"}}
    assert _judge({"a": 0.5, "b": 9.0}, lim) == (
        True, {"a": {"value": 0.5, "limit": 1.0}}, {"b": 9.0})
    assert not _judge({"a": 1.5, "b": 0.0}, lim)[0]
    assert not _judge({"a": float("nan")}, lim)[0]
    assert not _judge({"a": 0.5, "c": 0.0}, lim)[0]     # c has no limit
    assert not _judge({"b": 0.0}, lim)[0]               # nothing compared


def test_readers_find_nothing_without_a_trace():
    from bench.harness.record import Record
    rec = Record(sizes={}, traffic={})
    for m in SPEC["per_layer"]:
        assert reader(m["name"])(rec) is None, m["name"]


@pytest.mark.parametrize("model,mix,trace", [
    ("granite", "gen", False), ("granite", "gen", True),
    ("granite", "train", False), ("granite", "train", True)])
def test_the_result_line(model, mix, trace):
    cell = smoke_cell(model, mix)
    line = run_cell(cell, 2**31 + 77, 0.5, trace, torch.device("cpu"), 0.0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    json.dumps(line)
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:       # the end-to-end metrics are all there
        assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    if trace and mix == "gen":     # the profiler's cost, from CUDA events
        assert set(line["trace_cost"]) <= {
            f"{k}_ms_{w}" for k in ("decode", "prefill")
            for w in ("profiled", "unprofiled")}


def test_the_command_refuses_a_host_without_the_gpu():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


# ----------------------------------------------------------------------
# correct: a sound run passes, each planted fault fails
# ----------------------------------------------------------------------
def _limits(workload: str) -> dict:
    return json.loads((ROOT / f"bench/limits/{workload}.json").read_text())


def _run(model, mix):
    cell = smoke_cell(model, mix, _limits(smoke_cell(model, mix).name))
    return run_cell(cell, 2**31 + 5, 0.6, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("model", ["granite"])
@pytest.mark.parametrize("mix", ["gen", "train"])
def test_a_sound_run_is_correct(model, mix):
    assert _run(model, mix)["correct"]


def _alter_one_token(monkeypatch):
    """Each request's second token is replaced where it is produced."""
    from repro_torch.runtime.batcher import ContinuousBatcher
    real = ContinuousBatcher.step

    def step(self):
        n = real(self)
        for r in self.slot_req:
            if r is not None and len(r.tokens) == 2:
                r.tokens[-1] = (r.tokens[-1] + 1) % self.cfg.vocab_size
        return n
    monkeypatch.setattr(ContinuousBatcher, "step", step)


def _decode_keeps_state(monkeypatch):
    """The decode step writes its cache into copies: the
    batcher's state is left unchanged."""
    from repro_torch.models import model as M
    real = M.decode_step

    def copy(t):
        return ({k: copy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())

    monkeypatch.setattr(M, "decode_step", lambda p, c, tok, cache: real(
        p, c, tok, copy(cache)))


def _decode_half_the_slots(monkeypatch):
    """The second half of the slots gets the first half's logits."""
    from repro_torch.models import model as M
    real = M.decode_step

    def step(p, c, tok, cache):
        logits, cache = real(p, c, tok, cache)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h]]), cache
    monkeypatch.setattr(M, "decode_step", step)


def _train_keeps_state(monkeypatch):
    """The train step runs and then restores the state it was given."""
    from repro_torch.runtime import steps
    real = steps.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def kept(state, batch):
            saved = [t.clone() for t in _leaves(state)]
            state, met = step(state, batch)
            for t, s in zip(_leaves(state), saved):
                t.copy_(s)
            return state, met
        return kept
    monkeypatch.setattr(steps, "make_train_step", make)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _train_half_batch(monkeypatch):
    """Half of each batch left out, the loss the mean over the rest."""
    from bench.calibrate import half_batch_fault
    half_batch_fault(monkeypatch.setattr)


@pytest.mark.parametrize("model", ["granite"])
@pytest.mark.parametrize("mix,fault", [
    ("gen", _alter_one_token), ("gen", _decode_keeps_state),
    ("gen", _decode_half_the_slots), ("train", _train_keeps_state),
    ("train", _train_half_batch)])
def test_a_planted_fault_is_not_correct(model, mix, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(model, mix)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("model", ["granite"])
@pytest.mark.parametrize("mix", ["gen", "train"])
def test_control_readings(model, mix):
    """The control's readings come beside the program's, on the same
    sample and weights (``bench/calibrate.py``)."""
    line = run_cell(smoke_cell(model, mix), 11, 0.6, False,
                    torch.device("cpu"), 0.0, control="fp8")
    ctl = line["control"]
    if mix == "gen":
        assert set(ctl) == {"served_gap", "altered_token"}
        assert ctl["altered_token"] > line["checks"]["served_gap"]["value"]
    else:
        assert set(ctl) == set(line["checks"])
        assert ctl["grad_gap"] > line["checks"]["grad_gap"]["value"]
    assert line["control_correct"] is False     # no limits: nothing passes


@pytest.mark.parametrize("workload", CELLS)
def test_the_limits_fail_their_control_readings(workload):
    """The limits as committed, judged on each seed's control reading
    (and each planted fault's) from the cell's limits file: not correct
    on any of them."""
    from bench.harness.runner import _judge
    limits = _limits(workload)
    compared = {k: v for k, v in limits.items()
                if not k.startswith("_") and v["limit"] is not None}
    for kind in ("control", "altered_token", "half_batch"):
        runs = [v[kind] for v in compared.values() if kind in v]
        for i in range(min(map(len, runs), default=0)):
            readings = {k: v[kind][i] for k, v in compared.items()
                        if kind in v}
            assert not _judge(readings, limits)[0], (kind, i, readings)
    assert any("control" in v for v in compared.values())


def test_the_open_loop_sends_on_its_own(monkeypatch):
    """calibrate.py's open loop: requests at Poisson times from the end
    of set-up, whatever has finished."""
    from bench.calibrate import open_loop
    from bench.drivers import serve
    monkeypatch.setattr(serve, "Loop", open_loop(serve.Loop, 40.0, 3))
    line = run_cell(smoke_cell("granite", "gen"), 3, 1.0, False,
                    torch.device("cpu"), 0.0)
    assert 10 <= line["load"]["sent"] <= 90, line["load"]
