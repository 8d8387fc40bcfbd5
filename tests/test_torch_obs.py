"""The port's flight recorder and telemetry plane (``repro_torch.obs``).

Mirrors ``tests/test_obs.py`` and ``tests/test_telemetry_plane.py`` on
the port, where the port has the feature (the drift sentinel, the
calibration store and the benchmark gate wait for the tuning slice):
the tracer's nesting, cross-thread spans, ring eviction and Chrome
export; reservoir histograms; the OpenMetrics render and strict parse;
the SLO health monitor's hysteresis; the drift log, its rotation and
report; the engine's traced request timelines, drift rows and health.
Across the two packages: the same metric observations render the same
OpenMetrics text (after the ``device`` label is normalised), and
``predict_features(schedule_features(s)) == modeled_schedule_time(s)``
exactly for every Table-I app's schedule.
"""
from __future__ import annotations

import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import DataflowGraph, compile_graph   # noqa: E402
from repro_torch.core import apps as tapps                 # noqa: E402
from repro_torch.core.vectorize import (H100, GPUSpec,     # noqa: E402
                                        modeled_schedule_time,
                                        plane_features, schedule_features)
from repro_torch.frontend.lib import (JACOBI3, LAPLACE3,   # noqa: E402
                                      conv_taps)
from repro_torch.obs import (DriftLog, Histogram,          # noqa: E402
                             MetricsRegistry, Tracer, drift_report,
                             export_chrome_trace, load_chrome_trace,
                             predict_features, resolve_drift,
                             resolve_tracer, spearman,
                             validate_chrome_trace)
from repro_torch.obs.drift import DriftRow                 # noqa: E402
from repro_torch.obs.exporter import (CONTENT_TYPE,        # noqa: E402
                                      MetricFamily, MetricsHTTPServer,
                                      flatten_report, parse_openmetrics,
                                      registry_families, render_openmetrics,
                                      validate_openmetrics, write_openmetrics)
from repro_torch.obs.health import SLO, STATES, HealthMonitor  # noqa: E402
from repro_torch.runtime import StreamEngine, Telemetry    # noqa: E402

CPU = {"device": "cpu"}
T = 60                   # seconds: every result() has a timeout


def _pointwise():
    g = DataflowGraph("obs_pw")
    x = g.input("x", (8, 128))
    g.output(g.point(x, lambda v: v * 2.0, name="dbl"), "y")
    return g


def _diamond(h=32, w=128, name="diamond"):
    g = DataflowGraph(name)
    x = g.input("x", (h, w))
    s1 = g.stencil(x, (3, 3), conv_taps(LAPLACE3), name="lap")
    s2 = g.stencil(x, (3, 3), conv_taps(JACOBI3), name="jac")
    g.output(g.point2(s1, s2, lambda u, v: u - v, name="merge"), "y")
    return g


def _row(modeled, measured, kind="launch", sig="sig", attrs=None):
    return DriftRow(kind, sig, [[8, 128]], "torch", modeled, measured, attrs)


# ----------------------------------------------------------------------
# tracer core
# ----------------------------------------------------------------------
def test_span_nesting_and_exit_attrs():
    tr = Tracer()
    with tr.span("outer", cat="t", a=1) as sp:
        with tr.span("inner", cat="t"):
            pass
        sp.set(b=2)
    evs = tr.events()
    assert [(e.ph, e.name) for e in evs] == [
        ("B", "outer"), ("B", "inner"), ("E", "inner"), ("E", "outer")]
    assert evs[0].args == {"a": 1} and evs[-1].args == {"b": 2}


def test_cross_thread_begin_end():
    tr = Tracer()
    tok = tr.begin("xfer", cat="t")
    th = threading.Thread(target=lambda: tr.end(tok))
    th.start()
    th.join()
    (ev,) = tr.events()
    assert ev.ph == "X" and ev.name == "xfer" and ev.dur >= 0.0
    assert ev.tid == threading.main_thread().ident


def test_concurrent_interleaved_spans_validate(tmp_path):
    tr = Tracer()
    barrier = threading.Barrier(4)

    def work(i: int):
        barrier.wait()
        for j in range(50):
            with tr.span(f"req{i}", cat="load", j=j):
                with tr.span("step", cat="load"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = validate_chrome_trace(
        export_chrome_trace(tr, str(tmp_path / "t.json")))
    assert stats["spans"] == 4 * 50 * 2 and stats["threads"] == 4


def test_ring_drops_oldest_never_blocks(tmp_path):
    tr = Tracer(capacity=64)
    for i in range(500):
        with tr.span(f"s{i}", cat="t"):
            pass
    assert len(tr) == 64 and tr.dropped == 2 * 500 - 64
    names = [e.name for e in tr.events()]
    assert "s0" not in names and "s499" in names
    validate_chrome_trace(export_chrome_trace(tr, str(tmp_path / "r.json")))


def test_disabled_tracer_resolves_to_none_and_is_truthy_when_live():
    assert resolve_tracer(False) is None
    assert resolve_tracer(Tracer(enabled=False)) is None
    tr = Tracer()
    assert resolve_tracer(tr) is tr and bool(tr) and len(tr) == 0
    assert isinstance(resolve_tracer(True), Tracer)
    with pytest.raises(TypeError):
        resolve_tracer("out.json")


def test_global_tracer_install_and_env(tmp_path, monkeypatch):
    from repro_torch.obs import tracer as tmod
    tr = tmod.install()
    try:
        assert tmod.get_tracer() is tr and resolve_tracer(None) is tr
    finally:
        tmod.uninstall()
    assert resolve_tracer(None) is None
    monkeypatch.setattr(tmod, "_ENV_CHECKED", False)
    monkeypatch.setenv(tmod.TRACE_ENV, "1")
    try:
        assert isinstance(tmod.get_tracer(), Tracer)
    finally:
        tmod.uninstall()


def test_counter_instant_and_export_roundtrip(tmp_path):
    tr = Tracer()
    tr.instant("mark", cat="t")
    tr.counter("depth", 3)
    with tr.span("a", cat="t"):
        pass
    aid = tr.new_id()
    now = time.perf_counter()
    tr.async_span("phase", aid, now, now + 1e-3, cat="req")
    path = str(tmp_path / "out.json")
    export_chrome_trace(tr, path)
    payload = load_chrome_trace(path)
    assert payload["displayTimeUnit"] == "ms"
    assert {"i", "C"} <= {e["ph"] for e in payload["traceEvents"]}
    stats = validate_chrome_trace(payload)
    assert stats["spans"] == 1 and stats["async_spans"] == 1
    tr.clear()
    assert len(tr) == 0


def test_validate_rejects_unbalanced():
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [
            {"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 0},
            {"ph": "E", "name": "b", "pid": 1, "tid": 1, "ts": 1},
        ]})


def test_compile_trace_spans():
    tr = Tracer()
    compile_graph(_pointwise(), backend="torch", trace=tr, **CPU)
    names = {e.name for e in tr.events() if e.ph == "B"}
    assert {"compile", "compile.lower", "compile.host",
            "compile.partition", "compile.pass.auto-split",
            "compile.pass.dead-channel", "compile.pass.point-fusion",
            "compile.vectorize.sweep"} <= names


# ----------------------------------------------------------------------
# metrics: reservoir histograms, and the same text in both packages
# ----------------------------------------------------------------------
def test_histogram_reservoir_sees_late_run():
    h = Histogram("lat", capacity=500, seed=0)
    h.extend([1.0] * 5000)
    assert h.percentile(99) == 1.0
    h.extend([100.0] * 5000)
    assert h.count == 10_000 and h.percentile(99) == 100.0


def test_histogram_deterministic_seed_and_registry_conflict():
    a, b = Histogram("x", 64, 7), Histogram("x", 64, 7)
    a.extend(range(10_000))
    b.extend(range(10_000))
    assert a.samples() == b.samples()
    reg = MetricsRegistry()
    reg.counter("n")
    with pytest.raises(ValueError):
        reg.histogram("n")


def _observe(reg_cls, tel_cls):
    reg = reg_cls()
    reg.counter("served").inc(7)
    reg.gauge("depth").set(3.0)
    reg.histogram("latency_s", 64, 0).extend(
        [((i * 7919) % 1000) * 1e-5 for i in range(500)])
    reg.histogram("empty_s")
    tel = tel_cls(max_samples=64, seed=3)
    now = 100.0
    tel.observe_batches([(now + i, 4, {"launch": 1e-3 * (i % 5),
                                        "queue_wait": [1e-4 * i] * 4},
                          [2e-3 + 1e-5 * i] * 4, 5e-3) for i in range(40)])
    tel.observe_submits(160, list(range(160)))
    return reg, tel


def test_same_observations_render_the_same_openmetrics_in_both_packages():
    from repro.obs.exporter import registry_families as j_families
    from repro.obs.exporter import render_openmetrics as j_render
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro.runtime.telemetry import Telemetry as JTelemetry
    labels = {"backend": "b", "device": "DEV", "app": "a"}
    reg, tel = _observe(MetricsRegistry, Telemetry)
    jreg, jtel = _observe(JRegistry, JTelemetry)
    rules = {f"phase_{p}_s": ("phase_seconds", {"phase": p})
             for p in ("queue_wait", "form", "stack", "launch", "readback")}
    for r, jr in ((reg, jreg), (tel.registry, jtel.registry)):
        text = render_openmetrics(registry_families(r, labels=labels,
                                                    rules=rules))
        jtext = j_render(j_families(jr, labels=labels, rules=rules))
        assert text == jtext
        validate_openmetrics(text)
    snap, jsnap = tel.snapshot(flat=True), jtel.snapshot(flat=True)
    assert snap == jsnap


def test_telemetry_p99_tracks_late_latency_shift():
    tel = Telemetry(max_samples=1000, seed=0)
    now = time.perf_counter()
    tel.observe_batches([(now, 8, None, [0.001] * 100, None)
                         for _ in range(50)])
    assert tel.snapshot()["latency_p99_ms"] == pytest.approx(1.0)
    tel.observe_batches([(now, 8, None, [0.5] * 100, None)
                         for _ in range(50)])
    assert tel.snapshot()["latency_p99_ms"] > 100.0


def test_telemetry_empty_and_nonfinite_are_json_safe():
    snap = Telemetry().snapshot()
    assert snap["latency_samples"] == 0 and snap["latency_p50_ms"] is None
    text = json.dumps(snap)
    assert "NaN" not in text and "Infinity" not in text
    t = Telemetry()
    now = time.perf_counter()
    t.observe_batches([(now, 2, {}, [0.01, float("nan")], None),
                       (now, 2, {}, [float("inf"), 0.03], None)])
    snap = t.snapshot()
    assert snap["completed"] == 4 and snap["latency_samples"] == 2
    assert math.isfinite(snap["latency_p99_ms"])
    assert t.snapshot(flat=True)["latency_samples"] == 2


def test_telemetry_snapshot_concurrent_with_flush():
    t = Telemetry()
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader():
        try:
            while not stop.is_set():
                json.dumps(t.snapshot())
        except BaseException as e:    # noqa: BLE001 - surfacing to main
            errors.append(e)

    th = threading.Thread(target=reader)
    th.start()
    now = time.perf_counter()
    for i in range(300):
        t.observe_batches([(now + i * 1e-4, 3,
                            {"launch": [1e-4], "form": 2e-4},
                            [1e-3, 2e-3], 1e-3)])
    stop.set()
    th.join()
    assert not errors and t.snapshot()["completed"] == 600


# ----------------------------------------------------------------------
# OpenMetrics exporter
# ----------------------------------------------------------------------
def test_openmetrics_round_trip_label_escaping():
    fam = MetricFamily("weird", "gauge", 'help with "quotes"\nand lines')
    nasty = {"app": 'say "hi"', "path": "a\\b", "msg": "line\nbreak"}
    fam.add(1.5, nasty)
    parsed = parse_openmetrics(render_openmetrics([fam]))
    (suffix, labels, value), = parsed["weird"]["samples"]
    assert suffix == "" and value == 1.5 and labels == nasty


def test_openmetrics_counter_total_and_summary_series():
    reg = MetricsRegistry()
    reg.counter("served").inc(7)
    reg.histogram("latency_s").extend([0.01, 0.02, 0.04])
    reg.histogram("empty_s")
    parsed = parse_openmetrics(render_openmetrics(
        registry_families(reg, labels={"app": "a"})))
    (suffix, labels, value), = parsed["repro_served"]["samples"]
    assert suffix == "_total" and value == 7 and labels["app"] == "a"
    quantiles = {l["quantile"] for _, l, _ in
                 parsed["repro_latency_s"]["samples"] if "quantile" in l}
    assert quantiles == {"0.5", "0.9", "0.99"}
    assert {s for s, _, _ in parsed["repro_empty_s"]["samples"]} == {
        "_count", "_sum"}


def test_openmetrics_skips_none_and_nonfinite_and_rejects_bad_text():
    fam = MetricFamily("g", "gauge")
    for v, k in ((None, "none"), (float("nan"), "nan"), (2.0, "ok")):
        fam.add(v, {"k": k})
    parsed = parse_openmetrics(render_openmetrics([fam]))
    assert [l["k"] for _, l, _ in parsed["g"]["samples"]] == ["ok"]
    good = render_openmetrics([MetricFamily("x", "gauge")])
    with pytest.raises(ValueError, match="EOF"):
        parse_openmetrics(good.replace("# EOF\n", ""))
    with pytest.raises(ValueError, match="_total"):
        parse_openmetrics("# TYPE c counter\nc 1\n# EOF\n")
    with pytest.raises(ValueError, match="duplicate"):
        render_openmetrics([MetricFamily("d", "gauge"),
                            MetricFamily("d", "counter")])
    assert validate_openmetrics(good)["families"] == 1


def test_openmetrics_file_export_and_flatten(tmp_path):
    path = str(tmp_path / "metrics.prom")
    write_openmetrics(path, render_openmetrics([MetricFamily("up", "gauge")]))
    with open(path) as f:
        parse_openmetrics(f.read())
    assert flatten_report({"a": {"b": {"c": 1}}, "d": 2}) == {
        "a.b.c": 1, "d": 2}


def test_metrics_http_server_scrape_monotone_counters():
    reg = MetricsRegistry()
    reg.counter("hits").inc(3)
    with MetricsHTTPServer(
            lambda: render_openmetrics(registry_families(reg))) as srv:
        def scrape():
            with urllib.request.urlopen(srv.url, timeout=10) as resp:
                assert resp.headers["Content-Type"] == CONTENT_TYPE
                return parse_openmetrics(resp.read().decode())
        v1 = scrape()["repro_hits"]["samples"][0][2]
        reg.counter("hits").inc(2)
        v2 = scrape()["repro_hits"]["samples"][0][2]
        assert (v1, v2) == (3, 5) and srv.scrapes >= 2


# ----------------------------------------------------------------------
# SLO health monitor
# ----------------------------------------------------------------------
def test_health_alternating_violation_never_flaps_to_breach():
    mon = HealthMonitor(SLO(max_shed_rate=None, max_queue_depth=4))
    states = [mon.evaluate(queue_depth=10 if i % 2 else 0)["state"]
              for i in range(12)]
    assert "breach" not in states and states[-1] == "degraded"


def test_health_breach_and_recovery_pass_through_degraded():
    mon = HealthMonitor(SLO(max_shed_rate=None, max_queue_depth=4))
    for _ in range(3):
        mon.evaluate(queue_depth=10)
    assert mon.state == "breach"
    for _ in range(3):
        mon.evaluate(queue_depth=0)
    assert [(f, t) for _, f, t, _ in mon.transitions] == [
        ("healthy", "degraded"), ("degraded", "breach"),
        ("breach", "degraded"), ("degraded", "healthy")]


def test_health_shed_rate_and_latency_window():
    mon = HealthMonitor(SLO(max_shed_rate=0.05))
    assert mon.evaluate(submitted=100, shed=0)["violated"] == []
    assert mon.evaluate(submitted=100, shed=10)["violated"] == ["shed_rate"]
    assert mon.evaluate(submitted=100, shed=10)["violated"] == []
    mon = HealthMonitor(SLO(latency_p99_s=0.001, max_shed_rate=None),
                        min_latency_samples=20)
    mon.observe_latencies([1.0] * 5)
    assert mon.evaluate()["violated"] == []
    mon.observe_latencies([1.0] * 20)
    assert mon.evaluate()["violated"] == ["latency_p99"]


def test_health_registry_counters_and_state_gauge():
    reg = MetricsRegistry()
    mon = HealthMonitor(SLO(max_shed_rate=None, max_queue_depth=1),
                        breach_after=2, registry=reg)
    mon.evaluate(queue_depth=5)
    mon.evaluate(queue_depth=5)
    assert reg.gauge("health_state").value == float(STATES.index("breach"))
    assert reg.counter("health_transitions").value == 2


# ----------------------------------------------------------------------
# drift capture
# ----------------------------------------------------------------------
def test_drift_log_persists_reports_and_rotates(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    for m, s in zip([1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]):
        log.record("launch", "sig", [[96, 256]], "torch", m * 1e-5, s * 1e-5,
                   label=f"m{m}")
    log.flush()
    rows = DriftLog(log.path).rows()
    assert [r.attrs["label"] for r in rows][:2] == ["m1.0", "m2.0"]
    rep = drift_report(DriftLog(log.path))
    assert rep["n"] == 4 and rep["spearman"] == pytest.approx(-1.0)
    cap = DriftLog(str(tmp_path / "r.jsonl"), max_rows=10)
    for i in range(32):
        cap.record("launch", f"s{i}", [[8, 8]], "torch", 1e-5, 2e-5)
        if i % 8 == 7:
            cap.flush()
    assert cap.rotated_rows == 16
    assert [r.signature for r in cap.rows()] == [f"s{i}"
                                                for i in range(16, 32)]


def test_drift_report_skips_sick_rows_and_spearman_edges():
    clean = [_row(1e-5, 2e-5), _row(2e-5, 3e-5), _row(3e-5, 5e-5)]
    sick = [_row(float("nan"), 1e-5), _row(1e-5, float("inf")),
            _row(0.0, 1e-5)]
    rep = drift_report(clean + sick)
    assert rep["n"] == 3 and rep["skipped"] == 3
    assert np.isnan(spearman([1.0], [2.0]))
    assert spearman([1, 2, 2, 3], [1, 2, 2, 3]) == pytest.approx(1.0)


def test_resolve_drift_semantics(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_DRIFT_LOG", raising=False)
    assert resolve_drift(None) is None and resolve_drift(False) is None
    path = str(tmp_path / "d.jsonl")
    monkeypatch.setenv("REPRO_DRIFT_LOG", path)
    assert resolve_drift(None).path == path
    with pytest.raises(TypeError):
        resolve_drift(3.14)


@pytest.mark.parametrize("name", sorted(tapps.APPS))
def test_predict_features_equals_modeled_schedule_time(name):
    """Bit for bit, under the default spec and a card's other one, and
    through a JSON round trip (what a drift row on disk holds)."""
    sched = tapps.compile_app(name, 1080, 1920, **CPU).schedule
    for spec in (H100, GPUSpec(sms=114, hbm_bw=2.0e12)):
        feats = schedule_features(sched, spec=spec)
        want = modeled_schedule_time(sched, spec)
        assert predict_features(feats, spec) == want
        assert predict_features(json.loads(json.dumps(feats)), spec) == want
        assert predict_features(schedule_features(sched, 8, spec), spec) \
            == pytest.approx(8 * want, rel=1e-12)
    g = sched.groups[0]
    assert set(plane_features(g, g.tile)) == {
        "blocks", "bytes_block", "ops_block", "fill", "waves"}


# ----------------------------------------------------------------------
# the engine's observability wiring
# ----------------------------------------------------------------------
def test_engine_trace_single_id_contiguous_phases(tmp_path):
    tr = Tracer()
    with StreamEngine(backend="torch", max_batch=4, trace=tr, **CPU) as eng:
        h = eng.submit(_pointwise(), {"x": np.ones((8, 128), np.float32)})
        h.result(timeout=T)
    aids = {e.aid for e in tr.events()
            if e.cat == "request" and e.aid is not None}
    assert len(aids) == 1
    aid = aids.pop()
    evs = [e for e in tr.events() if e.cat == "request" and e.aid == aid]
    b_ts = {e.name: e.ts for e in evs if e.ph == "b"}
    e_ts = {e.name: e.ts for e in evs if e.ph == "e"}
    chain = ["queue_wait", "form", "stack", "launch", "execute",
             "readback"]
    phases = sorted((e for e in evs if e.ph == "b" and e.name != "request"),
                    key=lambda e: e.ts)
    assert [e.name for e in phases] == chain
    assert b_ts["queue_wait"] == pytest.approx(b_ts["request"], abs=1e-9)
    for prev, nxt in zip(chain, chain[1:]):
        assert e_ts[prev] == pytest.approx(b_ts[nxt], abs=1e-9)
    assert e_ts["readback"] == pytest.approx(e_ts["request"], abs=1e-9)
    assert {e.name for e in tr.events() if e.cat == "batcher"} == {
        "batch.stack", "batch.launch"}
    validate_chrome_trace(export_chrome_trace(tr, str(tmp_path / "e.json")))


def test_engine_drift_rows_compile_then_launch(tmp_path):
    path = str(tmp_path / "drift.jsonl")
    with StreamEngine(backend="torch", max_batch=2, drift=path, **CPU) as eng:
        g = _pointwise()
        for i in range(3):
            eng.submit(g, {"x": np.full((8, 128), i, np.float32)}
                       ).result(timeout=T)
    rows = DriftLog(path).rows()
    assert len(rows) >= 3
    assert rows[0].kind == "compile" and "launch" in [r.kind for r in rows]
    sched = eng.cache.get(g, backend="torch", **CPU).schedule
    for r in rows:          # the modeled seconds are the features'
        assert r.modeled_s == predict_features(r.features, H100)
        assert r.modeled_s == modeled_schedule_time(sched) * r.attrs["width"]
    assert drift_report(DriftLog(path))["bias"] > 0


def test_untraced_engine_has_no_recorder_state():
    with StreamEngine(backend="torch", max_batch=2, **CPU) as eng:
        assert eng.tracer is None and eng.drift is None
        assert eng._batcher.tracer is None


def test_engine_health_and_scrape():
    g = _diamond()
    with StreamEngine(backend="torch", latency_budget=10.0, max_batch=4,
                      **CPU) as eng:
        eng.submit(g, {"x": np.zeros((32, 128), np.float32)}
                   ).result(timeout=T)
        out = eng.health()
        srv = eng.serve_metrics()
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            parsed = parse_openmetrics(resp.read().decode())
    assert out["state"] == "healthy"
    assert set(out["objectives"]) == {"latency_p99", "shed_rate"}
    (_, labels, value), = parsed["repro_completed"]["samples"]
    assert value == 1 and labels["device"] == "cpu"
    assert labels["backend"] == "torch"
    phases = {l["phase"] for _, l, _ in
              parsed["repro_phase_seconds"]["samples"]}
    assert phases == {"queue_wait", "form", "stack", "launch", "readback"}
    assert parsed["repro_app_served"]["samples"][0][2] == 1
    assert "repro_bucket_launches" in parsed
