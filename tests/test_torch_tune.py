"""The port's profile-guided autotuner: store round-trips, the measured
search, cache hits with zero measurements, serving integration, and
parity with the JAX package under one schedule config.

Twins of ``tests/test_tuning.py`` on the port (the replication test's
twin is in ``tests/test_torch_parallel.py``).  The search is exercised with
injected fake measurements (deterministic functions of the candidate
config) on the CPU, at planes of at most 96x256; two tests run the real
measurer on the CPU, where it times the plain versions.  Parity: under
the same ``ScheduleConfig`` the port's tuned app (``cuda_stream`` on the
CPU: the plain version) equals the JAX app (``backend="xla"``) within
1e-5 x max|ref| + 1e-5 x |ref| for every Table-I app on a ragged
37x150 plane.  The ``gpu`` tests (the real ``default_measure`` on the
card, a round's kernels built in one call, tuned == analytic bit for
bit) skip without a card.
"""
from __future__ import annotations

import dataclasses
import doctest
import importlib
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro_torch.obs.drift                                  # noqa: E402
import repro_torch.tune.search as search                      # noqa: E402
from repro_torch.backends import (Backend, UnsupportedBackendError,  # noqa: E402
                                  resolve)
from repro_torch.core import (H100, DataflowGraph, build_schedule,  # noqa: E402
                              compile_graph)
from repro_torch.core import apps as tapps                    # noqa: E402
from repro_torch.core.vectorize import (scale_spec, select_tile,  # noqa: E402
                                        smem_report, sweep_vector_factor)
from repro_torch.device import DeviceUnavailableError         # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.obs.drift import DriftLog                    # noqa: E402
from repro_torch.tune import (ScheduleConfig, TuningCache,    # noqa: E402
                              TuningKey, TuningRecord, tune_graph)
from repro_torch.tune.search import resolve_tuning            # noqa: E402

try:                                 # the card's machine has no JAX
    from repro.core import apps as japps
    from repro.core.compiler import compile_graph as jcompile
    from repro.tune import ScheduleConfig as JScheduleConfig
except ImportError:
    japps = None

CPU = {"device": "cpu"}
H, W = 37, 150                  # the ragged parity plane
APP_NAMES = sorted(tapps.APPS)
T = 60                          # seconds: every result() has a timeout


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


def _stencil_graph(h=64, w=256):
    g = DataflowGraph("tunable")
    x = g.input("img", (h, w))
    b = g.stencil(x, (3, 3), lambda p: sum(p[i] for i in range(9)) / 9.0)
    g.output(g.point2(x, b, lambda a, c: 2.0 * a - c), "out")
    return g


def _prefers_vf(target: int):
    """Fake measurer: fastest exactly at vector factor ``target``."""

    def measure(cfg: ScheduleConfig) -> float:
        vf = next(v for v in cfg.group_vf if v is not None)
        return 1.0 + abs(vf - target) + 0.1 * (cfg.max_tile[0] != 64)

    return measure


def _tune(g, cache, **kw):
    return tune_graph(g, "cuda_stream", cache=cache, **CPU, **kw)


# ----------------------------------------------------------------------
# TuningCache store
# ----------------------------------------------------------------------
def test_tuning_cache_round_trip(tmp_path):
    cache = TuningCache(str(tmp_path))
    key = TuningKey("sigdead", "cuda_stream", "cpu",
                    (("img", (64, 256), "float32"),))
    cfg = ScheduleConfig(group_vf=(3, None), max_tile=(32, 256),
                         vmem_fraction=0.5)
    cache.put(key, TuningRecord(config=cfg, source="measured",
                                best_measured_s=1e-3, n_trials=5))
    # a FRESH handle re-reads from disk: survives process restarts
    rec = TuningCache(str(tmp_path)).get(key)
    assert rec is not None
    assert rec.config == cfg
    assert rec.best_measured_s == 1e-3 and rec.n_trials == 5
    assert rec.created_at > 0


def test_tuning_cache_round_trip_identical_schedule(tmp_path):
    """save -> load -> recompile produces an identical Schedule."""
    cache = TuningCache(str(tmp_path))
    res = _tune(_stencil_graph(), cache, measure=_prefers_vf(2))
    first = compile_graph(_stencil_graph(), "cuda_stream", tune="auto",
                          tune_cache=cache, **CPU)
    second = compile_graph(_stencil_graph(), "cuda_stream", tune="auto",
                           tune_cache=cache, **CPU)
    tiles = [(gr.tile, gr.vector_factor) for gr in first.schedule.groups]
    assert tiles == [(gr.tile, gr.vector_factor)
                     for gr in second.schedule.groups]
    assert [v for v in res.config.group_vf if v is not None] == [2]
    assert all(gr.tile_source == "cache" for gr in second.schedule.groups
               if gr.tile is not None)


def test_tuning_cache_miss_on_different_key(tmp_path):
    cache = TuningCache(str(tmp_path))
    key = TuningKey("sig1", "cuda_stream", "cpu", ())
    cache.put(key, TuningRecord(config=ScheduleConfig(group_vf=(1,))))
    assert cache.get(dataclasses.replace(key, backend="torch")) is None
    assert cache.get(dataclasses.replace(
        key, device_kind="NVIDIA H100 80GB HBM3")) is None
    assert cache.get(dataclasses.replace(key, mode="plain")) is None
    assert cache.get(key) is not None


def test_tuning_cache_rejects_foreign_versions(tmp_path):
    cache = TuningCache(str(tmp_path))
    key = TuningKey("sigv", "cuda_stream", "cpu", ())
    rec = TuningRecord(config=ScheduleConfig(group_vf=(1,)), version=999)
    cache.put(key, rec)
    assert TuningCache(str(tmp_path)).get(key) is None


def test_signature_stable_across_code_object_identity():
    """The persistent cache key must not depend on memory addresses."""
    src = "lambda p: sum(p[i] for i in range(9)) / 9.0"

    def build():
        fn = eval(compile(src, "<probe>", "eval"))   # fresh code object
        g = DataflowGraph("sig")
        x = g.input("img", (32, 128))
        g.output(g.stencil(x, (3, 3), fn), "out")
        return g

    g1, g2 = build(), build()
    assert g1.stages[0].fn.__code__ is not g2.stages[0].fn.__code__
    assert g1.signature() == g2.signature()
    assert TuningKey.for_graph(g1, "cuda_stream", "cpu") == \
        TuningKey.for_graph(g2, "cuda_stream", "cpu")


# ----------------------------------------------------------------------
# the measured search
# ----------------------------------------------------------------------
def test_deterministic_winner_under_fake_measurements(tmp_path):
    """Same fake measurements -> same winner, twice over."""
    r1 = _tune(_stencil_graph(), TuningCache(str(tmp_path / "a")),
               measure=_prefers_vf(2))
    r2 = _tune(_stencil_graph(), TuningCache(str(tmp_path / "b")),
               measure=_prefers_vf(2))
    assert r1.source == r2.source == "measured"
    assert r1.config == r2.config
    assert 2 in r1.config.group_vf


@pytest.mark.parametrize("target", [1, 2, 3, 4])
def test_winner_never_slower_than_analytic_pick(tmp_path, target):
    """The analytic pick is always measured, so it bounds the winner."""
    res = _tune(_stencil_graph(), TuningCache(str(tmp_path)),
                measure=_prefers_vf(target), top_k=8)
    assert res.trials[0].label == "analytic"
    assert res.record.best_measured_s <= res.record.analytic_measured_s
    assert res.config.group_vf == (target,)


def test_cache_hit_means_zero_measurements(tmp_path):
    """The regression the persistent cache exists for."""
    cache = TuningCache(str(tmp_path))
    calls = {"n": 0}

    def counting(cfg: ScheduleConfig) -> float:
        calls["n"] += 1
        return _prefers_vf(2)(cfg)

    first = _tune(_stencil_graph(), cache, measure=counting)
    assert first.source == "measured"
    assert calls["n"] == first.n_measurements > 0

    before = calls["n"]
    again = _tune(_stencil_graph(), cache, measure=counting)
    assert again.source == "cache"
    assert again.n_measurements == 0
    assert calls["n"] == before            # not a single new measurement
    assert again.config == first.config


def test_cache_hit_after_canonicalization_alias(tmp_path):
    """A graph canonicalized in place still hits its own record."""
    cache = TuningCache(str(tmp_path))
    g = _stencil_graph()                    # non-canonical (multi-reader)
    _tune(g, cache, measure=_prefers_vf(2))
    res = _tune(g, cache, measure=_prefers_vf(2))
    assert res.source == "cache" and res.n_measurements == 0


def test_max_trials_caps_measurements(tmp_path):
    counting = {"n": 0}

    def measure(cfg):
        counting["n"] += 1
        return 1.0

    _tune(_stencil_graph(), TuningCache(str(tmp_path)), measure=measure,
          max_trials=2)
    assert counting["n"] == 2


def test_resolve_tuning_protocol(tmp_path):
    g = _stencil_graph()
    assert resolve_tuning(g, "cuda_stream", tune=None) is None
    assert resolve_tuning(g, "cuda_stream", tune="model") is None
    cfg = ScheduleConfig(group_vf=(1,))
    out = resolve_tuning(g, "cuda_stream", tune=cfg)
    assert out is not None and out[0] is cfg and out[1] == "config"
    with pytest.raises(ValueError, match="tune must be"):
        resolve_tuning(g, "cuda_stream", tune="bogus")
    with pytest.raises(ValueError, match="mutually exclusive"):
        compile_graph(g, "cuda_stream", tune="auto", vector_factor=2, **CPU)


def test_card_and_plain_modes_tune_separately(tmp_path):
    """Plain-version timings on the CPU must never serve the card (the
    reference's interpret/compiled split)."""
    cache = TuningCache(str(tmp_path))
    r_plain = _tune(_stencil_graph(), cache, measure=_prefers_vf(2))
    r_card = tune_graph(_stencil_graph(), "cuda_stream", cache=cache,
                        device="cuda", device_kind="cpu",
                        measure=_prefers_vf(2))
    assert r_plain.source == "measured"
    assert r_card.source == "measured"      # NOT a hit on the plain entry
    assert r_plain.key.mode == "plain"
    assert r_card.key.mode == "compiled"
    # and the device kind comes from the app's device
    assert r_plain.key.device_kind == "cpu"
    # each mode hits its own entry
    assert _tune(_stencil_graph(), cache).source == "cache"


def test_tune_rejects_max_tile_override():
    with pytest.raises(ValueError, match="mutually exclusive"):
        compile_graph(_stencil_graph(), "cuda_stream", tune="auto",
                      max_tile=(64, 256), **CPU)


def test_tune_model_is_the_analytic_default():
    """tune="model" names the no-tuning regime; it composes with the
    explicit knobs instead of tripping the mutual-exclusion guards."""
    app = compile_graph(_stencil_graph(), "cuda_stream", tune="model",
                        vector_factor=2, **CPU)
    assert all(g.vector_factor == 2 for g in app.schedule.groups
               if g.tile is not None)
    assert "via forced" in app.schedule.describe()


def test_tuning_key_separates_spec_and_strictness(tmp_path):
    """Configs measured under one spec/compile regime must not serve
    another: the context digest keeps the cache entries apart."""
    cache = TuningCache(str(tmp_path))
    r1 = _tune(_stencil_graph(), cache, measure=_prefers_vf(2))
    small = dataclasses.replace(H100, smem_per_block=H100.smem_per_block // 2)
    r2 = _tune(_stencil_graph(), cache, spec=small, measure=_prefers_vf(2))
    assert r2.source == "measured"         # NOT served from r1's entry
    assert r1.key.context != r2.key.context
    assert _tune(_stencil_graph(), cache, spec=small).source == "cache"
    canon = tapps.build_app("square", 64, 256)
    r3 = _tune(canon, cache, measure=_prefers_vf(2))
    r4 = _tune(tapps.build_app("square", 64, 256), cache, strict=True,
               measure=_prefers_vf(2))
    assert r4.source == "measured" and r3.key.context != r4.key.context


def test_entries_deduplicates_canonicalization_aliases(tmp_path):
    """One tuned app == one record, even when stored under both the
    pre- and post-canonicalization signatures."""
    cache = TuningCache(str(tmp_path))
    _tune(_stencil_graph(), cache, measure=_prefers_vf(2))
    files = [n for n in os.listdir(str(tmp_path)) if n.endswith(".json")]
    assert len(files) == 2                 # pre + post forms on disk
    assert len(cache) == 1                 # but ONE tuning result


def test_stale_config_infeasible_factor_falls_back():
    """A cached factor the plane can no longer hold degrades gracefully."""
    sched = build_schedule(_stencil_graph(64, 256),   # cap is vf=8
                           group_vector_factors=[10])
    assert any("no longer feasible" in d for d in sched.diagnostics)
    g0 = sched.groups[0]
    assert g0.tile is not None and g0.tile_source == "model"
    # an EXPLICIT infeasible vector_factor= stays a hard error
    with pytest.raises(ValueError, match="vector_factor=10"):
        build_schedule(_stencil_graph(64, 256), vector_factor=10)


def test_stale_config_length_mismatch_falls_back():
    """A config sized for a different partition degrades gracefully."""
    sched = build_schedule(_stencil_graph(),
                           group_vector_factors=[1, 1, 1, 1, 1])
    assert any("falling back to the analytic sweep" in d
               for d in sched.diagnostics)
    g0 = sched.groups[0]
    assert g0.tile is not None and g0.tile_source == "model"


def test_describe_provenance_lines(tmp_path):
    cache = TuningCache(str(tmp_path))
    _tune(_stencil_graph(), cache, measure=_prefers_vf(1))
    fresh = compile_graph(_stencil_graph(), "cuda_stream", tune="auto",
                          tune_cache=cache, **CPU)
    text = fresh.schedule.describe()
    assert "via cache" in text and "[tune] source=cache" in text
    default = compile_graph(_stencil_graph(), "cuda_stream", **CPU)
    assert "via model" in default.schedule.describe()
    forced = compile_graph(_stencil_graph(), "cuda_stream",
                           vector_factor=2, **CPU)
    assert "via forced" in forced.schedule.describe()


# ----------------------------------------------------------------------
# what the port adds: the round structure, the rows, the refusals
# ----------------------------------------------------------------------
def test_search_protocol_and_trial_rows(tmp_path):
    """Analytic first, then the model's widths, then the height caps;
    each trial leaves a drift row with per-kind features beside the
    cache; candidates that would run the same tiles are measured once.
    (A two-SM spec, so the model's pick at this small plane is taller
    than the lower caps.)"""
    cache = TuningCache(str(tmp_path))
    spec = dataclasses.replace(H100, sms=2)
    res = _tune(tapps.build_app("harris", 96, 256), cache, spec=spec,
                measure=lambda cfg: 1.0, top_k=8, max_trials=20)
    labels = [t.label for t in res.trials]
    assert labels[0] == "analytic"
    widths = [lb for lb in labels if lb.startswith("g0:vf")]
    heights = [lb for lb in labels if lb.startswith("max_tile")]
    assert widths and heights
    assert labels.index(widths[-1]) < labels.index(heights[0])
    plans = {search._plan(build_schedule(
        tapps.build_app("harris", 96, 256),
        **search.tuned_schedule_kwargs(t.config, "measured", spec)))
        for t in res.trials}
    assert len(plans) == len(res.trials)  # no tiling measured twice
    rows = DriftLog(os.path.join(cache.root, "drift.jsonl")).rows()
    assert [r.attrs["label"] for r in rows] == labels
    for r, t in zip(rows, res.trials):
        assert r.kind == "trial" and r.attrs["mode"] == "plain"
        assert r.measured_s == t.measured_s and r.modeled_s == t.modeled_s
        assert all(isinstance(g["ops_block"], dict)
                   for g in r.features["groups"])
        assert repro_torch.obs.drift.predict_features(r.features, spec) \
            == r.modeled_s


def test_a_failing_measurement_propagates(tmp_path):
    """A build or launch failure is never scored as a slow candidate."""
    def broken(cfg):
        raise build.KernelBuildError("nvcc failed")

    with pytest.raises(build.KernelBuildError):
        _tune(_stencil_graph(), TuningCache(str(tmp_path)), measure=broken)
    assert len(TuningCache(str(tmp_path))) == 0


def test_backend_without_tuning_refuses(tmp_path):
    gated = dataclasses.replace(resolve("torch"), name="no_tune",
                                capabilities=frozenset())
    with pytest.raises(UnsupportedBackendError) as ei:
        tune_graph(_stencil_graph(), gated, cache=TuningCache(str(tmp_path)),
                   measure=_prefers_vf(1), **CPU)
    assert ei.value.missing == ("tuning",)
    with pytest.raises(ValueError, match="unknown capabilities"):
        Backend("bad", lower=resolve("torch").lower,
                capabilities=frozenset({"teleport"}))


def test_default_measure_defaults_to_the_card(tmp_path):
    """Entry points run on the card unless asked for the CPU: without
    one, the real measurer raises rather than timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        tune_graph(_stencil_graph(), cache=TuningCache(str(tmp_path)),
                   drift=False)


def test_sweep_vector_factor_and_budget_helpers():
    """Each width is scored at its best height (the tile select_tile
    picks for it); scale_spec shrinks the fusion budget; smem_report
    describes a scheduled group."""
    sched = build_schedule(tapps.build_app("unsharp_mask", 96, 256))
    g = sched.groups[0]
    records = sweep_vector_factor(g, H100)
    assert records[-1]["feasible"] is False      # the sentinel factor
    for r in records[:-1]:
        tile, _ = select_tile(g, H100, width_factor=r["vector_factor"])
        assert tile == r["tile"] and r["features"]["blocks"] > 0
    best = min((r for r in records if r["feasible"]),
               key=lambda r: (r["modeled_s"], -r["tile"][0] * r["tile"][1]))
    tile, _ = select_tile(g, H100)
    assert tile == best["tile"]
    assert scale_spec(H100, 1.0) is H100
    assert scale_spec(H100, 0.5).smem_per_block == H100.smem_per_block // 2
    with pytest.raises(ValueError):
        scale_spec(H100, 0.0)
    rep = smem_report(g)
    assert rep["smem_bytes"] == g.smem_bytes() and rep["window_bytes"] > 0


def test_fusion_budget_axis_changes_the_partition(tmp_path):
    """A small enough budget splits harris's deep group: the third
    axis measures a different partition."""
    g = tapps.build_app("harris", 96, 256)
    full = build_schedule(g, spec=H100)
    tight = build_schedule(tapps.build_app("harris", 96, 256),
                           spec=scale_spec(H100, 0.02))
    assert len(tight.groups) > len(full.groups)
    res = _tune(tapps.build_app("harris", 96, 256), TuningCache(str(tmp_path)),
                measure=lambda cfg: cfg.vmem_fraction,
                vmem_fractions=(1.0, 0.02), drift=False)
    assert res.config.vmem_fraction == 0.02
    app = compile_graph(tapps.build_app("harris", 96, 256), tune=res.config,
                        **CPU)
    assert len(app.schedule.groups) == len(tight.groups)


@pytest.mark.parametrize("name", APP_NAMES)
def test_analytic_config_reapplies_the_analytic_tiles(name):
    """The search's first trial is the analytic schedule itself: its
    factors re-applied give back every group's tile."""
    model = build_schedule(tapps.build_app(name, 96, 256))
    vfs = [None if g.is_trivial else g.vector_factor for g in model.groups]
    again = build_schedule(tapps.build_app(name, 96, 256),
                           group_vector_factors=vfs)
    assert [g.tile for g in again.groups] == [g.tile for g in model.groups]


# ----------------------------------------------------------------------
# integration: real measurements (plain versions) and serving
# ----------------------------------------------------------------------
def test_tuned_app_is_bit_exact_and_correct(tmp_path):
    cache = TuningCache(str(tmp_path))
    app = compile_graph(tapps.build_app("gaussian_blur", 32, 256),
                        tune="auto", tune_cache=cache, **CPU)
    plain = compile_graph(tapps.build_app("gaussian_blur", 32, 256), **CPU)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 256)).astype(np.float32))
    # tuning picks tiles, never semantics: bit-exact vs the untuned app
    torch.testing.assert_close(app(img=x)["out"], plain(img=x)["out"],
                               rtol=0, atol=0)
    ref = tapps.build_app("gaussian_blur", 32, 256).reference_eval(
        {"img": x})
    torch.testing.assert_close(app(img=x)["out"], ref["out"], rtol=1e-5,
                               atol=1e-6)
    assert all(gr.tile_source in ("measured", "cache")
               for gr in app.schedule.groups if gr.tile is not None)
    assert len(cache) == 1


def test_engine_serves_tuned_schedules_through_compile_cache(tmp_path,
                                                             monkeypatch):
    """StreamEngine(tune="auto") warm-starts at the tuned point."""
    from repro_torch.runtime import StreamEngine

    cache = TuningCache(str(tmp_path))
    res = _tune(_stencil_graph(32, 256), cache, measure=_prefers_vf(2))
    calls = {"n": 0}
    real = search.default_measure

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(search, "default_measure", counting)
    rng = np.random.default_rng(1)
    frames = [rng.normal(size=(32, 256)).astype(np.float32)
              for _ in range(6)]
    with StreamEngine(backend="cuda_stream", max_batch=4, tune="auto",
                      tune_cache=cache, **CPU) as eng:
        handles = [eng.submit(_stencil_graph(32, 256), {"img": f})
                   for f in frames]
        outs = [h.result(timeout=T) for h in handles]
        rep = eng.report()
    assert calls["n"] == 0                 # zero measurements: cache-served
    plain = compile_graph(_stencil_graph(32, 256), **CPU)
    np.testing.assert_array_equal(
        outs[0]["out"], plain(img=torch.from_numpy(frames[0]))["out"].numpy())
    prov = [m["tile_provenance"] for m in rep["modeled"].values()]
    assert prov and all(p == ["cache"] for p in prov)
    assert 2 in res.config.group_vf


# ----------------------------------------------------------------------
# parity with the JAX package under one schedule config
# ----------------------------------------------------------------------
def _inputs(name, seed=0):
    g = japps.build_app(name, H, W)
    rng = np.random.default_rng(seed)
    return {c.name: rng.standard_normal(c.shape).astype(np.float32)
            for c in g.graph_inputs}


@pytest.mark.parametrize("name", APP_NAMES)
def test_tuned_app_matches_jax_under_one_config(name, request):
    """One ScheduleConfig (JSON) applied to both packages: the port's
    tuned app on the CPU equals the JAX app on ``xla``."""
    if japps is None:
        pytest.skip("needs JAX and the repro package")
    model = build_schedule(tapps.build_app(name, H, W))
    cfg_json = {"group_vf": [None if g.is_trivial else 1
                             for g in model.groups],
                "max_tile": [16, 128], "vmem_fraction": 1.0}
    app = compile_graph(tapps.build_app(name, H, W),
                        tune=ScheduleConfig.from_json(cfg_json), **CPU)
    assert all(g.tile_source == "config" and g.tile[1] == 32
               for g in app.schedule.groups if g.tile is not None)
    japp = jcompile(japps.build_app(name, H, W), backend="xla",
                    tune=JScheduleConfig.from_json(cfg_json))
    ins = _inputs(name)
    ref = {k: np.asarray(v) for k, v in japp(**ins).items()}
    out = app(**ins)
    assert set(out) == set(ref)
    worst = 0.0
    for k in ref:
        port = out[k].numpy()
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        err = np.abs(port - ref[k])
        assert (err <= 1e-5 * scale + 1e-5 * np.abs(ref[k])).all(), \
            f"{name}/{k}: max rel err {err.max() / scale:.3e}"
        worst = max(worst, float(err.max() / scale))
    request.node.user_properties.append(("max_rel_err", worst))


_DOC_MODULES = ["repro_torch.core.compiler", "repro_torch.core.schedule",
                "repro_torch.obs.drift", "repro_torch.obs.sentinel",
                "repro_torch.tune.calibrate", "repro_torch.tune.search",
                "repro_torch.tune.store"]


@pytest.mark.parametrize("name", _DOC_MODULES)
def test_docstring_examples(name, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    module = importlib.import_module(name)
    result = doctest.testmod(module, verbose=False)
    assert result.attempted > 0, f"{module.__name__} lost its examples"
    assert result.failed == 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_default_measure_times_the_kernels_on_the_card(tmp_path):
    _needs_card()
    g = tapps.build_app("gaussian_blur", 1080, 1920)
    cfg = ScheduleConfig(group_vf=(4,))
    s = search.default_measure(g, "cuda_stream", cfg, reps=5)
    # a full-HD blur is tens of microseconds on the card, far under
    # the milliseconds a host readback would add
    assert 1e-6 < s < 1e-3
    res = tune_graph(tapps.build_app("gaussian_blur", 1080, 1920),
                     cache=TuningCache(str(tmp_path)), max_trials=4)
    assert res.key.mode == "compiled"
    assert res.key.device_kind == torch.cuda.get_device_name()
    assert res.n_measurements == len(res.trials) <= 4
    assert res.record.best_measured_s <= res.record.analytic_measured_s


@pytest.mark.gpu
def test_a_round_is_built_in_one_call(tmp_path, monkeypatch):
    _needs_card()
    calls = []
    real = build.build_libraries

    def recording(kernels):
        todo = [n for n, src in kernels
                if not build.library_path(n, src).exists()]
        if todo:                        # a call that builds something
            calls.append(todo)
        return real(kernels)

    monkeypatch.setattr(build, "build_libraries", recording)
    res = tune_graph(tapps.build_app("unsharp_mask", 540, 960),
                     cache=TuningCache(str(tmp_path)), top_k=4, max_trials=8,
                     drift=False)
    # one building call a round (analytic, widths, heights), each with
    # every candidate of its round; none during a measurement
    assert 1 <= len(calls) <= 3
    assert sum(len(c) for c in calls) == res.n_builds >= 1
    assert res.build_s > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gaussian_blur", "harris",
                                  "optical_flow_lk"])
def test_tuned_equals_analytic_bit_for_bit_on_the_card(tmp_path, name):
    _needs_card()
    cache = TuningCache(str(tmp_path))
    tuned = compile_graph(tapps.build_app(name, 1079, 1917), tune="auto",
                          tune_cache=cache)
    analytic = compile_graph(tapps.build_app(name, 1079, 1917))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = {c.name: torch.randn(c.shape, device="cuda", generator=gen)
           for c in analytic.schedule.graph.graph_inputs}
    out_t, out_a = tuned(**ins), analytic(**ins)
    for k in out_a:
        assert torch.equal(out_t[k], out_a[k]), k
