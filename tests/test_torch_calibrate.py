"""The port's calibrated cost model: the fit, its invariants, the
wiring, and the golden fixture from the card.

Twins of ``tests/test_calibration.py`` on the port's model.  On
synthetic drift rows generated from a *known* spec, :func:`calibrate`
recovers that spec's constants (to 1e-5 when noiseless, within
tolerance under noise), is invariant to row order and duplication, and
falls back to the seed spec — warning, never NaN — whenever the data
cannot identify the constants.  The fit is linear in
``[wave_overhead_s, 1/hbm_bw, ii_scale[kind] / fp32_flops]`` once each
group's memory-or-compute branch is decided; ``fill`` is taken as
recorded.

The golden fixture, ``tests/fixtures/torch_drift_h100.jsonl``, holds the
trial rows of ``chip_smoke.py`` phase 9 (four apps at 1080x1920 tuned on
an NVIDIA H100 80GB HBM3 at 700 W; the card's name and power limit in
every row).  The reference's own fixture holds CPU-host rows in the TPU
model's features and cannot feed this fit.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.backends import resolve, resolve_calibrated  # noqa: E402
from repro_torch.core import H100, GPUSpec, compile_graph      # noqa: E402
from repro_torch.core import apps as tapps                     # noqa: E402
from repro_torch.core import build_schedule                    # noqa: E402
from repro_torch.core.vectorize import modeled_schedule_time   # noqa: E402
from repro_torch.obs.drift import (DriftLog, DriftRow,         # noqa: E402
                                   drift_report, predict_features)
from repro_torch.runtime import CompileCache, StreamEngine     # noqa: E402
from repro_torch.tune import TuningCache, TuningKey, tune_graph  # noqa: E402
from repro_torch.tune.calibrate import (CALIBRATION_VERSION,   # noqa: E402
                                        MIN_ROWS, CalibratedSpec,
                                        CalibrationStore, calibrate,
                                        calibrate_backend, load_calibration,
                                        resolve_calibration, spec_from_json,
                                        spec_to_json)

CPU = {"device": "cpu"}
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_drift_h100.jsonl")


# ----------------------------------------------------------------------
# synthetic-recovery property harness
# ----------------------------------------------------------------------
def _true_spec() -> CalibratedSpec:
    """Ground truth deliberately far from every H100 seed constant."""
    return CalibratedSpec(fp32_flops=5e12, hbm_bw=2e11,
                          wave_overhead_s=3e-5,
                          ii_scale=(("point", 1.0), ("stencil", 2.5)))


def _synth_rows(rng: np.random.Generator, true_spec: GPUSpec,
                n: int = 24, noise: float = 0.0,
                kind: str = "trial") -> list[DriftRow]:
    """Drift rows whose measured time IS the true spec's prediction.

    Cycles through the four regimes that make every constant
    identifiable: wave-overhead-dominated, memory-bound (pins
    ``hbm_bw``) and compute-bound per stage kind (pins each
    ``ii_scale / fp32_flops``).  ``fill`` varies per row, as it does on
    the card.
    """
    rows = []
    regimes = ("overhead", "dma", "compute_point", "compute_stencil")
    for i in range(n):
        regime = regimes[i % len(regimes)]
        fill = float(rng.uniform(0.25, 1.0))
        blocks = int(rng.integers(100, 2000))
        if regime == "overhead":
            g = {"blocks": int(rng.integers(8, 64)),
                 "bytes_block": float(rng.integers(100, 1000)),
                 "ops_block": {"point": float(rng.integers(50, 500))},
                 "fill": fill, "waves": int(rng.integers(64, 256))}
        elif regime == "dma":
            g = {"blocks": blocks,
                 "bytes_block": float(rng.integers(10, 80)) * 2.0 ** 16,
                 "ops_block": {"point": float(rng.integers(100, 1000))},
                 "fill": fill, "waves": int(rng.integers(1, 6))}
        elif regime == "compute_point":
            g = {"blocks": blocks,
                 "bytes_block": float(rng.integers(100, 1000)),
                 "ops_block": {"point": float(rng.integers(4, 40)) * 1e5},
                 "fill": fill, "waves": int(rng.integers(1, 6))}
        else:
            g = {"blocks": blocks,
                 "bytes_block": float(rng.integers(100, 1000)),
                 "ops_block": {"stencil": float(rng.integers(4, 40)) * 1e5},
                 "fill": fill, "waves": int(rng.integers(1, 6))}
        feats = {"groups": [g]}
        measured = predict_features(feats, true_spec)
        if noise:
            measured *= float(np.exp(rng.normal(0.0, noise)))
        rows.append(DriftRow(kind, f"sig{i % 5}", [[64, 128]],
                             "cuda_stream", 1e-5, measured,
                             {"features": feats}))
    return rows


def _alpha(spec, kind: str) -> float:
    """Gauge-invariant per-kind cost: the fit pins the reference kind's
    multiplier to 1.0, so only ``ii_scale / fp32_flops`` compares."""
    return dict(spec.ii_scale).get(kind, 1.0) / spec.fp32_flops


def _assert_recovered(result, true_spec: GPUSpec, rel: float) -> None:
    assert result.fitted, result.warning
    s = result.spec
    assert s.wave_overhead_s == pytest.approx(true_spec.wave_overhead_s,
                                              rel=rel)
    assert s.hbm_bw == pytest.approx(true_spec.hbm_bw, rel=rel)
    for kind, _ in s.ii_scale:
        assert _alpha(s, kind) == pytest.approx(_alpha(true_spec, kind),
                                                rel=rel), kind


@pytest.mark.parametrize("seed", range(6))
def test_noiseless_recovery_is_exact(seed):
    true = _true_spec()
    rows = _synth_rows(np.random.default_rng(seed), true)
    result = calibrate(rows)
    _assert_recovered(result, true, rel=1e-5)
    # and the fitted spec re-predicts every measurement: the model
    # family contains the generator
    for r in rows:
        pred = predict_features(r.features, result.spec)
        assert pred == pytest.approx(r.measured_s, rel=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_noisy_recovery_within_tolerance(seed):
    true = _true_spec()
    rows = _synth_rows(np.random.default_rng(100 + seed), true,
                       n=48, noise=0.02)
    _assert_recovered(calibrate(rows), true, rel=0.35)


def test_row_order_and_duplication_invariance():
    true = _true_spec()
    rows = _synth_rows(np.random.default_rng(7), true)
    base = calibrate(rows).spec
    shuffled = list(reversed(rows)) + rows[::3] + rows   # perm + dupes
    again = calibrate(shuffled)
    # bit-identical: canonicalization sorts and dedupes first
    assert again.spec == base
    assert again.n_duplicates == len(shuffled) - len(rows)


def test_too_few_rows_falls_back_with_warning():
    rows = _synth_rows(np.random.default_rng(3), _true_spec(),
                       n=MIN_ROWS - 1)
    with pytest.warns(RuntimeWarning, match="fell back"):
        result = calibrate(rows)
    assert not result.fitted
    assert result.spec is H100                 # the seed, untouched
    assert "min_rows" in result.warning
    for f in dataclasses.fields(GPUSpec):
        assert math.isfinite(float(getattr(result.spec, f.name)))


def test_rank_deficient_design_falls_back():
    # every row spends the same waves per operation, so the overhead and
    # compute columns are proportional: no amount of rows splits them
    rows = []
    for blocks in range(2, 14):
        feats = {"groups": [{"blocks": blocks, "bytes_block": 64.0,
                             "ops_block": {"point": 1e7}, "fill": 1.0,
                             "waves": blocks}]}
        rows.append(DriftRow("trial", "sig", [[8, 128]], "cuda_stream", 1e-5,
                             predict_features(feats, _true_spec()),
                             {"features": feats}))
    with pytest.warns(RuntimeWarning, match="rank-deficient"):
        result = calibrate(rows)
    assert not result.fitted and result.spec is H100


def test_unusable_rows_skipped_never_nan():
    true = _true_spec()
    rows = _synth_rows(np.random.default_rng(11), true)
    one = {"groups": [{"blocks": 1, "bytes_block": 1.0,
                       "ops_block": {"point": 1.0}, "fill": 1.0,
                       "waves": 1}]}
    junk = [
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, float("nan"),
                 {"features": one}),
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, float("inf"),
                 {"features": one}),
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, 1e-4, None),
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, 1e-4,
                 {"features": {"groups": [dict(one["groups"][0],
                                               blocks=-2)]}}),
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, 1e-4,
                 {"features": {"groups": [dict(one["groups"][0],
                                               fill=0.0)]}}),
        # a row written before the operations were split by kind
        DriftRow("trial", "s", None, "cuda_stream", 1e-5, 1e-4,
                 {"features": {"groups": [dict(one["groups"][0],
                                               ops_block=1.0)]}}),
    ]
    result = calibrate(rows + junk)
    assert result.n_unusable == len(junk)
    _assert_recovered(result, true, rel=1e-5)


def test_compile_rows_excluded_by_default():
    # engine `compile` rows include building the kernels; 80x-polluted
    # rows must not shift the fit, because the default excludes them
    true = _true_spec()
    rng = np.random.default_rng(5)
    clean = _synth_rows(rng, true, n=16)
    polluted = _synth_rows(rng, true, n=8, kind="compile")
    for r in polluted:
        r.measured_s *= 80.0
    result = calibrate(clean + polluted)
    assert result.n_excluded == len(polluted)
    _assert_recovered(result, true, rel=1e-5)
    assert result.spec == calibrate(clean).spec
    everything = calibrate(clean + polluted, exclude_kinds=())
    assert everything.n_excluded == 0
    assert everything.n_rows == len(clean) + len(polluted)
    assert everything.spec != result.spec


def test_huber_resists_outliers():
    rows = _synth_rows(np.random.default_rng(9), _true_spec(), n=40)
    for r in rows[::10]:                       # a few preempted trials
        r.measured_s *= 25.0
    _assert_recovered(calibrate(rows, huber_delta=3.0), _true_spec(),
                      rel=0.35)


def test_hypothesis_noiseless_recovery():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(seed=st.integers(0, 2 ** 31 - 1),
               n=st.integers(MIN_ROWS, 64))
    def check(seed, n):
        rows = _synth_rows(np.random.default_rng(seed), _true_spec(), n=n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            result = calibrate(rows)
        if result.fitted:                  # small n may be deficient
            _assert_recovered(result, _true_spec(), rel=1e-5)
        else:
            assert result.spec is H100

    check()


# ----------------------------------------------------------------------
# the golden fixture: the card's trial rows
# ----------------------------------------------------------------------
def _fixture_rows() -> list[DriftRow]:
    with open(_FIXTURE) as f:
        return [DriftRow.from_dict(json.loads(line)) for line in f]


def test_golden_fixture_seed_model_on_the_card():
    rows = _fixture_rows()
    assert len(rows) >= MIN_ROWS
    assert all(r.attrs["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
               and r.attrs["power_limit_w"] == 700.0
               and r.attrs["mode"] == "compiled" for r in rows)
    rep = drift_report(rows)
    # the data-sheet model orders the card's trials only loosely and
    # predicts 3.6x too fast: the kernels run at 14-44 % of the bound
    assert rep["n"] == len(rows)
    assert rep["spearman"] == pytest.approx(0.7722489939, abs=1e-6)
    assert rep["bias"] == pytest.approx(3.619269063, rel=1e-6)


def test_golden_fixture_fit_on_the_card():
    rows = _fixture_rows()
    result = calibrate(rows, spec=H100)
    assert result.fitted, result.warning
    before = drift_report(rows)
    after = drift_report(rows, spec=result.spec)["with_spec"]
    assert after["n"] == len(rows)
    # the fit removes most of the bias...
    assert abs(math.log10(after["bias"])) < 0.3, after
    assert abs(after["log10_bias"]) < abs(before["log10_bias"])
    # ...but not the misordering: every group stays on the memory
    # branch, so the ranking is the seed's (ROADMAP.md, A5)
    assert after["spearman"] == pytest.approx(before["spearman"], abs=1e-12)
    assert result.spec.wave_overhead_s > H100.wave_overhead_s
    assert result.spec.hbm_bw < H100.hbm_bw


# ----------------------------------------------------------------------
# calibrated tuning: same winner, fewer measurements
# ----------------------------------------------------------------------
def _blur_graph():
    return tapps.build_app("gaussian_blur", 96, 256)


def test_calibrated_search_prunes_to_same_winner(tmp_path):
    def measured(cfg):                  # wider tiles are faster
        return 1.0 / (cfg.group_vf[0] or 1)

    # a fitted spec dominated by the cost of a wave on a one-SM card:
    # the 32-wide tile (two waves) is modeled 2x the others
    cal_spec = CalibratedSpec(wave_overhead_s=1e-3, sms=1,
                              ii_scale=(("stencil", 1.0),), n_rows=9)
    uncal = tune_graph(_blur_graph(), "cuda_stream",
                       cache=TuningCache(str(tmp_path / "a")),
                       measure=measured, top_k=8, **CPU)
    cal = tune_graph(_blur_graph(), "cuda_stream",
                     cache=TuningCache(str(tmp_path / "b")),
                     measure=measured, top_k=8, calibrate=cal_spec, **CPU)
    assert uncal.source == cal.source == "measured"
    assert cal.config == uncal.config            # same winner
    assert cal.n_measurements < uncal.n_measurements, \
        (cal.n_measurements, uncal.n_measurements)
    assert cal.n_pruned >= 1
    assert uncal.n_pruned == 0       # the seed spec has not earned pruning
    assert cal.record.n_pruned == cal.n_pruned
    assert any("pruned" in line for line in cal.notes())
    rec = TuningCache(str(tmp_path / "b")).get(cal.key)
    assert rec is not None and rec.n_pruned == cal.n_pruned
    # the calibrated search keeps its own record
    assert cal.key.backend != uncal.key.backend


def test_uncalibrated_spec_never_prunes(tmp_path):
    res = tune_graph(_blur_graph(), "cuda_stream",
                     cache=TuningCache(str(tmp_path / "c")),
                     measure=lambda cfg: 1.0 / (cfg.group_vf[0] or 1),
                     prior_ratio=0.0, **CPU)  # maximally aggressive ratio
    assert res.n_pruned == 0                  # ...still gated on evidence


# ----------------------------------------------------------------------
# feature round-trips
# ----------------------------------------------------------------------
@pytest.mark.parametrize("app", ["gaussian_blur", "filter_chain", "harris"])
def test_predict_features_matches_compiler_model(app):
    sched = build_schedule(tapps.build_app(app, 64, 256))
    feats = sched.features()
    assert predict_features(feats, H100) == modeled_schedule_time(sched, H100)
    feats3 = sched.features(items=3)
    assert predict_features(feats3, H100) == pytest.approx(
        3 * modeled_schedule_time(sched, H100), rel=1e-12)
    # and under a calibrated spec, with its per-kind multipliers
    cal = CalibratedSpec(fp32_flops=1e11, ii_scale=(("point", 3.0),
                                                    ("stencil", 0.5)))
    assert predict_features(sched.features(spec=cal), cal) == \
        modeled_schedule_time(sched, cal)
    if app == "harris":
        assert modeled_schedule_time(sched, cal) != modeled_schedule_time(
            sched, dataclasses.replace(H100, fp32_flops=1e11))


def test_rows_with_a_scalar_ops_block_still_predict():
    """Rows written before the operations were split by kind (a scalar
    ``ops_block``) predict as they did: the scalar is priced unscaled."""
    sched = build_schedule(tapps.build_app("harris", 64, 256))
    feats = sched.features()
    legacy = {"groups": [dict(g, ops_block=sum(g["ops_block"].values()))
                         for g in feats["groups"]]}
    assert predict_features(legacy, H100) == predict_features(feats, H100)
    cal = CalibratedSpec(ii_scale=(("stencil", 7.0),))
    assert predict_features(legacy, cal) == predict_features(legacy, H100)


def test_engine_drift_rows_repredict_exactly(tmp_path):
    from repro_torch.core import DataflowGraph
    g = DataflowGraph("cal_pw")
    x = g.input("x", (8, 128))
    g.output(g.point(x, lambda v: v + 1.0, name="inc"), "y")
    path = str(tmp_path / "drift.jsonl")
    with StreamEngine(backend="torch", max_batch=2, drift=path,
                      **CPU) as eng:
        for i in range(3):
            eng.submit(g, {"x": np.full((8, 128), i, np.float32)}
                       ).result(timeout=60)
    rows = DriftLog(path).rows()
    assert rows and all(r.features is not None for r in rows)
    for r in rows:
        assert predict_features(r.features, H100) == pytest.approx(
            r.modeled_s, rel=1e-12)
    # too few rows for a fit — and the build-polluted compile rows are
    # visibly excluded, not silently mixed in
    with pytest.warns(RuntimeWarning):
        result = calibrate(rows)
    assert not result.fitted
    assert result.n_excluded == sum(r.kind == "compile" for r in rows)


# ----------------------------------------------------------------------
# persistence + resolution + key separation
# ----------------------------------------------------------------------
def test_spec_json_roundtrip_exact():
    s = CalibratedSpec(fp32_flops=3.217e13, hbm_bw=7.7e11,
                       wave_overhead_s=1.12e-5,
                       ii_scale=(("point", 1.0), ("stencil", 3.25)),
                       n_rows=14)
    assert spec_from_json(json.loads(json.dumps(spec_to_json(s)))) == s


def test_calibration_store_roundtrip(tmp_path):
    store = CalibrationStore(str(tmp_path))
    spec = CalibratedSpec(fp32_flops=2e13, ii_scale=(("stencil", 1.0),),
                          n_rows=10)
    assert store.get("cuda_stream", "cpu") is None
    store.put("cuda_stream", "cpu", spec)
    assert store.get("cuda_stream", "cpu") == spec
    assert CalibrationStore(str(tmp_path)).get("cuda_stream", "cpu") == spec
    assert store.get("cuda_stream", "NVIDIA H100 80GB HBM3") is None
    store.invalidate("cuda_stream", "cpu")
    assert CalibrationStore(str(tmp_path)).get("cuda_stream", "cpu") is None


def test_calibration_store_skips_other_versions(tmp_path):
    store = CalibrationStore(str(tmp_path))
    path = store.put("p@x", "cpu", CalibratedSpec(n_rows=10))
    with open(path) as f:
        raw = json.load(f)
    raw["version"] = CALIBRATION_VERSION + 1
    with open(path, "w") as f:
        json.dump(raw, f)
    assert CalibrationStore(str(tmp_path)).get("p@x", "cpu") is None


def test_calibrate_backend_persists_and_auto_resolves(tmp_path):
    store = CalibrationStore(str(tmp_path))
    rows = _synth_rows(np.random.default_rng(2), _true_spec())
    result = calibrate_backend("cuda_stream", rows, store=store,
                               device_kind="testdev")
    assert result.fitted
    loaded = load_calibration("cuda_stream", store=store,
                              device_kind="testdev")
    assert loaded == result.spec
    assert resolve_calibration("cuda_stream", "auto", store=store,
                               device_kind="testdev") == result.spec
    assert resolve_calibration("cuda_stream", None, store=store) is None
    assert resolve_calibration("cuda_stream", False, store=store) is None
    passthrough = resolve_calibration("cuda_stream", result.spec,
                                      store=store)
    assert passthrough is result.spec
    with pytest.raises(TypeError):
        resolve_calibration("cuda_stream", "atuo", store=store)


def test_auto_fits_from_drift_log_when_store_empty(tmp_path):
    store = CalibrationStore(str(tmp_path / "s"))
    log = DriftLog(str(tmp_path / "d.jsonl"))
    for r in _synth_rows(np.random.default_rng(4), _true_spec()):
        log.record(r.kind, r.signature, r.shapes, r.backend, r.modeled_s,
                   r.measured_s, **r.attrs)
    log.flush()
    spec = resolve_calibration("cuda_stream", "auto", store=store,
                               device_kind="testdev", drift=log.path)
    assert isinstance(spec, CalibratedSpec)
    assert load_calibration("cuda_stream", store=store,
                            device_kind="testdev") == spec


def test_uncalibrated_backend_identity_and_digest_split(tmp_path):
    be = resolve("cuda_stream")
    # opting out returns the registered record itself: the compile and
    # tuning keys of every uncalibrated run are untouched
    assert resolve_calibrated("cuda_stream", None) is be
    assert resolve_calibrated("cuda_stream", False) is be
    assert resolve_calibrated(be, None) is be
    spec = CalibratedSpec(fp32_flops=2e13, ii_scale=(("stencil", 1.0),),
                          n_rows=9)
    cal = resolve_calibrated("cuda_stream", spec)
    assert cal.cache_key() != be.cache_key()   # calibrated: own namespace
    assert cal.name == be.name and cal.spec is spec
    assert resolve("cuda_stream") is be        # registry not mutated
    # the tuning key splits...
    g = _blur_graph()
    assert TuningKey.for_graph(g, cal, "cpu") != TuningKey.for_graph(
        g, be, "cpu")
    # ...and so do the compile cache and the app's signature
    cache = CompileCache()
    a = cache.get(_blur_graph(), "cuda_stream", **CPU)
    b = cache.get(_blur_graph(), "cuda_stream", calibrate=spec, **CPU)
    assert a is not b and cache.stats.misses == 2
    assert a.signature() != b.signature()
    assert b.backend.spec is spec
    assert cache.get(_blur_graph(), "cuda_stream", calibrate=spec,
                     **CPU) is b


def test_compile_graph_calibrate_spec_is_semantics_preserving():
    cal_spec = CalibratedSpec(wave_overhead_s=1e-3,
                              ii_scale=(("stencil", 1.0),), n_rows=9)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(96, 256)).astype(np.float32))
    ref = compile_graph(_blur_graph(), **CPU)(img=x)["out"]
    app = compile_graph(_blur_graph(), calibrate=cal_spec, **CPU)
    assert torch.equal(ref, app(img=x)["out"])
    assert app.backend.spec is cal_spec
