"""The port's drift sentinel and its versioned calibration store.

Twins of the sentinel and versioned-store tests of
``tests/test_telemetry_plane.py`` on the port: the store bumps ``seq``
and keeps stale ancestors in ``history``; the sentinel stays quiet on a
short window, fits an uncalibrated backend, retires a fit whose bias
drifted and refits, rate-limits its polls, ignores other backends' rows
and excluded kinds, counts into the metrics registry; and the
``StreamEngine``'s ``sentinel=`` argument arms it, after which the
engine's own worker loop persists a versioned fit that
``compile_graph(calibrate="auto")`` then resolves with no manual step.
Synthetic rows (the port's per-kind features) are modeled under a
deliberately mis-scaled spec and "measured" under a known one.  All on
the CPU at planes of at most 32x128.
"""
from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.backends import resolve, resolve_calibrated  # noqa: E402
from repro_torch.core import DataflowGraph, compile_graph      # noqa: E402
from repro_torch.frontend.lib import (JACOBI3, LAPLACE3,       # noqa: E402
                                      conv_taps)
from repro_torch.obs import (DriftLog, DriftSentinel,          # noqa: E402
                             MetricsRegistry, SentinelPolicy,
                             parse_openmetrics, predict_features)
from repro_torch.runtime import StreamEngine                   # noqa: E402
from repro_torch.tune.calibrate import (CALIBRATION_VERSION,   # noqa: E402
                                        CalibratedSpec, CalibrationStore,
                                        spec_to_json)
from repro_torch.tune.store import detect_device_kind          # noqa: E402

CPU = {"device": "cpu"}
KIND = "cpu"                    # the device kind of a CPU-served engine


def _diamond(h=32, w=128, name="diamond"):
    g = DataflowGraph(name)
    x = g.input("x", (h, w))
    s1 = g.stencil(x, (3, 3), conv_taps(LAPLACE3), name="lap")
    s2 = g.stencil(x, (3, 3), conv_taps(JACOBI3), name="jac")
    g.output(g.point2(s1, s2, lambda u, v: u - v, name="merge"), "y")
    return g


def _true_spec() -> CalibratedSpec:
    """Ground truth deliberately far from every seed constant."""
    return CalibratedSpec(fp32_flops=5e12, hbm_bw=2e11,
                          wave_overhead_s=3e-5,
                          ii_scale=(("point", 1.0), ("stencil", 2.5)))


def _alpha(spec, kind: str = "point") -> float:
    """Gauge-invariant per-kind cost (``ii_scale / fp32_flops``)."""
    return dict(spec.ii_scale)[kind] / spec.fp32_flops


def _trial_features(i: int) -> dict:
    """Cycle the four regimes that make every constant identifiable;
    the multiplier varies with ``i`` so dedup keeps a full-rank fit."""
    regime = ("overhead", "dma", "compute_point", "compute_stencil")[i % 4]
    m = 1 + (i % 6)
    fill = (0.25, 0.5, 1.0)[i % 3]
    if regime == "overhead":
        g = {"blocks": 16, "bytes_block": 512.0,
             "ops_block": {"point": 200.0}, "fill": fill, "waves": 64 * m}
    elif regime == "dma":
        g = {"blocks": 200 * m, "bytes_block": 2.0 ** 21,
             "ops_block": {"point": 500.0}, "fill": fill, "waves": 1}
    elif regime == "compute_point":
        g = {"blocks": 200 * m, "bytes_block": 512.0,
             "ops_block": {"point": 2e6}, "fill": fill, "waves": 1}
    else:
        g = {"blocks": 200 * m, "bytes_block": 512.0,
             "ops_block": {"stencil": 2e6}, "fill": fill, "waves": 1}
    return {"groups": [g]}


def _write_trials(log: DriftLog, *, backend_key: str, n: int = 24,
                  mis_scale: float = 10.0, measured_scale: float = 1.0,
                  backend: str = "torch") -> None:
    """Append trial rows: modeled under a mis-scaled spec, measured
    under the true one (scaled by ``measured_scale`` to simulate the
    card drifting after a fit)."""
    true = _true_spec()
    for i in range(n):
        feats = _trial_features(i)
        measured = predict_features(feats, true) * measured_scale
        log.record("trial", f"sig{i % 5}", [[32, 128]], backend,
                   predict_features(feats, true) / mis_scale, measured,
                   features=feats, backend_key=backend_key)
    log.flush()


def _sentinel(tmp_path, log, **kw):
    store = kw.pop("store", None) or CalibrationStore(str(tmp_path / "s"))
    policy = kw.pop("policy", SentinelPolicy(min_interval_s=0.0))
    return DriftSentinel(log, "torch", store=store, policy=policy,
                         device="cpu", **kw), \
        store, resolve("torch").cache_key()


# ----------------------------------------------------------------------
# versioned calibration store
# ----------------------------------------------------------------------
def test_store_put_bumps_seq_and_keeps_history(tmp_path):
    store = CalibrationStore(str(tmp_path))
    s1 = CalibratedSpec(fp32_flops=1e12, ii_scale=(("point", 1.0),),
                        n_rows=9)
    s2 = CalibratedSpec(fp32_flops=2e12, ii_scale=(("point", 1.0),),
                        n_rows=9)
    store.put("be@x", "cpu", s1)
    assert store.latest("be@x", "cpu")["seq"] == 1
    store.put("be@x", "cpu", s2)
    raw = store.latest("be@x", "cpu")
    assert raw["seq"] == 2 and raw["stale"] is False
    assert [e["seq"] for e in store.versions("be@x", "cpu")] == [2, 1]
    assert store.get("be@x", "cpu") == s2


def test_store_mark_stale_hides_fit_until_refit(tmp_path):
    store = CalibrationStore(str(tmp_path))
    s1 = CalibratedSpec(fp32_flops=1e12, ii_scale=(("point", 1.0),),
                        n_rows=9)
    store.put("be@x", "cpu", s1)
    assert store.mark_stale("be@x", "cpu")
    assert store.get("be@x", "cpu") is None       # kept but skipped
    assert store.latest("be@x", "cpu")["stale"] is True
    s2 = CalibratedSpec(fp32_flops=2e12, ii_scale=(("point", 1.0),),
                        n_rows=9)
    store.put("be@x", "cpu", s2)
    raw = store.latest("be@x", "cpu")
    assert raw["seq"] == 2                        # stale fits still count
    assert raw["history"][0]["stale"] is True     # ancestry preserved
    assert store.get("be@x", "cpu") == s2
    assert not store.mark_stale("missing", "cpu")


def test_store_reads_records_without_seq(tmp_path):
    """A record without seq/stale reads as seq 0."""
    store = CalibrationStore(str(tmp_path))
    spec = CalibratedSpec(fp32_flops=3e12, ii_scale=(("point", 1.0),),
                          n_rows=12)
    old = {"version": CALIBRATION_VERSION, "backend": "be@y",
           "device_kind": "cpu", "created_at": 0.0,
           "spec": spec_to_json(spec)}
    store._write(store._path("be@y", "cpu"), old)
    assert store.get("be@y", "cpu") == spec
    s2 = CalibratedSpec(fp32_flops=4e12, ii_scale=(("point", 1.0),),
                        n_rows=9)
    store.put("be@y", "cpu", s2)
    raw = store.latest("be@y", "cpu")
    assert raw["seq"] == 1
    assert raw["history"][0]["seq"] == 0
    assert store.get("be@y", "cpu") == s2


# ----------------------------------------------------------------------
# drift sentinel: staleness policy
# ----------------------------------------------------------------------
def test_sentinel_short_window_never_stale(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, _, key = _sentinel(tmp_path, log)
    _write_trials(log, backend_key=key, n=4)
    out = sent.check()
    assert out["n_rows"] == 4 and not out["stale"]


def test_sentinel_uncalibrated_then_fit_then_quiet(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, store, key = _sentinel(tmp_path, log)
    _write_trials(log, backend_key=key, n=24)
    out = sent.poll()
    assert out["reasons"] == ["uncalibrated"]
    assert out["refit"]["fitted"]
    assert sent.device_kind == KIND
    assert store.latest(key, KIND)["seq"] == 1
    fit = store.get(key, KIND)
    assert abs(_alpha(fit) - _alpha(_true_spec())) / _alpha(
        _true_spec()) < 0.05
    again = sent.poll()
    assert not again["stale"] and again["active_seq"] == 1
    assert sent.refits == 1


def test_sentinel_bias_drift_marks_stale_and_reversions(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, store, key = _sentinel(tmp_path, log)
    _write_trials(log, backend_key=key, n=24)
    assert sent.poll()["refit"]["fitted"]
    # the card drifts 3x slower: re-scored bias ~ log10(3) >> 0.15
    log.clear()
    _write_trials(log, backend_key=key, n=24, measured_scale=3.0)
    out = sent.poll()
    assert "bias" in out["reasons"]
    assert abs(out["log10_bias"] - math.log10(3.0)) < 0.1
    raw = store.latest(key, KIND)
    assert raw["seq"] == 2
    assert raw["history"][0]["stale"] is True     # decayed fit retired
    ratio = _alpha(store.get(key, KIND)) / _alpha(_true_spec())
    assert abs(ratio - 3.0) < 0.2


def test_sentinel_new_rows_trigger_and_rate_limit(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, _, key = _sentinel(
        tmp_path, log, policy=SentinelPolicy(min_interval_s=100.0,
                                             refit_rows=8))
    _write_trials(log, backend_key=key, n=24)
    assert sent.poll(now=0.0)["refit"]["fitted"]
    assert sent.poll(now=1.0) is None             # inside min_interval_s
    _write_trials(log, backend_key=key, n=8)
    out = sent.poll(now=200.0)
    assert out["reasons"] == ["new_rows"]         # fresh evidence
    assert out["n_new"] >= 8


def test_sentinel_ignores_other_backends_and_excluded_kinds(tmp_path):
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, _, key = _sentinel(tmp_path, log)
    _write_trials(log, backend_key=key, n=8)
    _write_trials(log, backend_key="other@deadbeef", n=8)
    log.record("compile", "sigc", [[8, 8]], "torch", 1e-3, 2e-3,
               backend_key=key)
    log.flush()
    assert len(sent.window_rows()) == 8
    # rows without a backend_key (the tuner's trials) match by name
    log.record("trial", "tuner", [[8, 8]], "torch", 1e-5, 2e-5,
               features=_trial_features(0))
    log.flush()
    assert len(sent.window_rows()) == 9


def test_sentinel_registry_counters(tmp_path):
    reg = MetricsRegistry()
    log = DriftLog(str(tmp_path / "d.jsonl"))
    sent, _, key = _sentinel(tmp_path, log, registry=reg)
    _write_trials(log, backend_key=key, n=24)
    sent.poll()
    assert reg.counter("sentinel_checks").value == 1
    assert reg.counter("sentinel_stale").value == 1
    assert reg.counter("sentinel_refits").value == 1
    assert reg.gauge("sentinel_rows").value == 24.0


def test_engine_sentinel_argument_validation(tmp_path):
    with StreamEngine(backend="torch", autostart=False, **CPU) as eng:
        assert eng.sentinel is None
    with pytest.raises(ValueError, match="drift"):
        StreamEngine(backend="torch", sentinel=True, autostart=False, **CPU)
    with pytest.raises(TypeError):
        StreamEngine(backend="torch", sentinel="yes", autostart=False,
                     drift=str(tmp_path / "d.jsonl"), **CPU)
    eng = StreamEngine(backend="torch", sentinel=SentinelPolicy(),
                       drift=str(tmp_path / "d.jsonl"), autostart=False,
                       **CPU)
    try:
        assert isinstance(eng.sentinel, DriftSentinel)
        assert eng.sentinel.device_kind == KIND
        assert eng.sentinel.registry is eng.telemetry.registry
    finally:
        eng.close()


def test_engine_with_sentinel_and_tuning_serves(tmp_path, monkeypatch):
    """``StreamEngine(sentinel=True, tune="auto")`` on the CPU: the first
    submit tunes (timing the plain versions), every request is served
    from the tuned app, and the sentinel watches the engine's log."""
    from repro_torch.tune import TuningCache
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    cache = TuningCache(str(tmp_path / "tune"))
    x = np.random.default_rng(3).normal(size=(32, 128)).astype(np.float32)
    with StreamEngine(backend="cuda_stream", sentinel=True, tune="auto",
                      tune_cache=cache, drift=str(tmp_path / "d.jsonl"),
                      max_batch=2, **CPU) as eng:
        outs = [eng.submit(_diamond(), {"x": x}).result(timeout=60)
                for _ in range(3)]
        rep = eng.report()
        check = eng.sentinel.check()
    want = compile_graph(_diamond(), **CPU)(x=x)["y"].numpy()
    for out in outs:
        np.testing.assert_array_equal(out["y"], want)
    assert len(cache) == 1
    assert [m["tile_provenance"] for m in rep["modeled"].values()] == [
        ["measured"]]
    assert check["device_kind"] == KIND and check["n_rows"] >= 1


# ----------------------------------------------------------------------
# end to end: the engine's worker loop closes the refit loop
# ----------------------------------------------------------------------
def test_engine_auto_recalibrates_and_scrapes_clean(tmp_path, monkeypatch):
    """Serve real traffic; the sentinel (not a human) closes the loop,
    and ``compile_graph(calibrate="auto")`` then resolves the refit
    spec; the engine's OpenMetrics exposition carries the sentinel's
    counters."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    key = resolve("torch").cache_key()
    assert detect_device_kind("cpu") == KIND
    log = DriftLog(str(tmp_path / "drift.jsonl"))
    _write_trials(log, backend_key=key, n=24, mis_scale=10.0)
    store = CalibrationStore(str(tmp_path))
    sentinel = DriftSentinel(
        log, "torch", store=store, device="cpu",
        policy=SentinelPolicy(min_interval_s=0.0),
        # the engine's own wall-clock rows must not dilute the
        # deterministic synthetic fit
        exclude_kinds=("compile", "launch"))

    g = _diamond()
    x = np.arange(32 * 128, dtype=np.float32).reshape(32, 128) / 100.0
    with StreamEngine(backend="torch", drift=log, sentinel=sentinel,
                      max_batch=4, max_queue=32, **CPU) as eng:
        for _ in range(4):
            eng.submit(g, {"x": x}).result(timeout=60)
        deadline = time.time() + 60.0
        while store.latest(key, KIND) is None and time.time() < deadline:
            time.sleep(0.05)
        raw = store.latest(key, KIND)
        assert raw is not None, "sentinel never persisted a fit"
        assert raw["seq"] >= 1 and raw["stale"] is False
        assert raw["fit"]["n_rows"] >= 8
        assert sentinel.refits >= 1
        parsed = parse_openmetrics(eng.openmetrics())
        assert "repro_sentinel_refits" in parsed
        assert "repro_sentinel_checks" in parsed
        served = parsed["repro_app_served"]["samples"]
        assert any(v >= 4 for _, lab, v in served if lab["app"] == "diamond")

    be = resolve_calibrated("torch", "auto", device_kind=KIND)
    fitted = store.get(key, KIND)
    assert isinstance(fitted, CalibratedSpec)
    assert be.spec == fitted
    assert abs(_alpha(fitted) - _alpha(_true_spec())) / _alpha(
        _true_spec()) < 0.05                         # ground truth
    app = compile_graph(g, backend="torch", calibrate="auto", **CPU)
    assert app.backend.spec == fitted
    ref = app.schedule.graph.reference_eval({"x": torch.from_numpy(x)})["y"]
    torch.testing.assert_close(app(x=x)["y"], ref, rtol=1e-5, atol=1e-5)
