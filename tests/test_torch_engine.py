"""The port's dataflow serving engine: engine, cache, micro-batcher,
telemetry.

Mirrors ``tests/test_runtime_engine.py`` and
``tests/test_continuous_batching.py`` on the port, on the CPU at small
planes (48x256, 8x128).  On the ``torch`` backend the engine is
bit-exact (atol 0) against the port's ``reference_eval``; the same
frames through the JAX ``StreamEngine(backend="xla")`` and the port's
engine agree within 1e-5 x max|ref| + 1e-5 x |ref|.  Every ``result()``
has a timeout.  The ``gpu`` test serves 40 requests on ``cuda_stream``
on the card; it skips without one.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import DataflowGraph, compile_graph   # noqa: E402
from repro_torch.core import apps as tapps                 # noqa: E402
from repro_torch.device import (DeviceUnavailableError,    # noqa: E402
                                NotPortedError)
from repro_torch.frontend.lib import (JACOBI3, LAPLACE3,   # noqa: E402
                                      conv_taps)
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels.stream_group import stream_group  # noqa: E402
from repro_torch.runtime import (PHASES, CancelledError,   # noqa: E402
                                 CompileCache, MicroBatcher, QueueFullError,
                                 SlotPool, StreamEngine, Telemetry,
                                 modeled_latency)
from repro_torch.runtime.engine import (_BUDGET_MAX_S,     # noqa: E402
                                        _BUDGET_MIN_S)

CPU = {"device": "cpu"}
T = 60                   # seconds: every result() has a timeout


def _diamond(h=8, w=128, name="diamond"):
    g = DataflowGraph(name)
    x = g.input("x", (h, w))
    s1 = g.stencil(x, (3, 3), conv_taps(LAPLACE3), name="lap")
    s2 = g.stencil(x, (3, 3), conv_taps(JACOBI3), name="jac")
    g.output(g.point2(s1, s2, lambda u, v: u - v, name="merge"), "y")
    return g


def _pointwise(h=8, w=128, name="act"):
    """A second topology (different signature than the diamond)."""
    g = DataflowGraph(name)
    x = g.input("x", (h, w))
    g.output(g.point(x, lambda v: torch.tanh(v) * 1.5, name="tanh"), "y")
    return g


def _frames(n, shape=(8, 128), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _ref(eng, g, backend="torch"):
    """The canonical graph the engine served (its reference_eval)."""
    return eng.cache.get(g, backend=backend, **CPU).schedule.graph


def _expect(ref_graph, inputs):
    return {k: v.numpy() for k, v in ref_graph.reference_eval(
        {k: torch.from_numpy(v) for k, v in inputs.items()}).items()}


class _Req:
    def __init__(self, x):
        self.inputs = {"x": x}


# ----------------------------------------------------------------------
# acceptance: the full engine path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "cuda_stream"])
def test_engine_e2e_32_requests_bit_exact_and_cached(backend):
    n = 32
    g = _diamond(48, 256)
    frames = _frames(n, (48, 256))
    with StreamEngine(backend=backend, max_batch=8, max_queue=64,
                      **CPU) as eng:
        handles = []
        lock = threading.Lock()

        def submit(chunk):
            for f in chunk:
                h = eng.submit(g, {"x": f})
                with lock:
                    handles.append((f, h))

        threads = [threading.Thread(target=submit, args=(frames[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [(f, h.result(timeout=T)) for f, h in handles]
        report = eng.report()

    ref_graph = _ref(eng, g, backend)
    for f, r in results:                       # atol=0
        np.testing.assert_array_equal(r["y"], _expect(ref_graph,
                                                      {"x": f})["y"])
    assert report["cache"]["misses"] == 1
    assert report["cache"]["hits"] == 0
    assert report["cache"]["requests"] == n
    m = report["measured"]
    assert m["completed"] == n and m["submitted"] == n
    assert m["latency_p50_ms"] <= m["latency_p99_ms"]
    mod = report["modeled"]["diamond"]
    assert mod["sequential"] > mod["dataflow"] > 0


def test_engine_under_thread_contention_loses_no_request():
    """More client threads than cores, two apps, a short switch
    interval: every request completes exactly once and bit-exactly, and
    the counters add up (a lost update would break one of them)."""
    import sys
    ga, gb = _diamond(name="a"), _pointwise(name="b")
    frames = _frames(64, seed=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with StreamEngine(backend="torch", max_batch=4, max_queue=8,
                          **CPU) as eng:
            handles = [None] * len(frames)

            def client(k):
                for i in range(k, len(frames), 16):
                    g = ga if i % 2 else gb
                    handles[i] = eng.submit(g, {"x": frames[i]}, timeout=T)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=T)
            assert not any(t.is_alive() for t in threads)
            results = [h.result(timeout=T) for h in handles]
            rep = eng.report()
    finally:
        sys.setswitchinterval(old)
    refs = {"a": _ref(eng, ga), "b": _ref(eng, gb)}
    for i, (f, r) in enumerate(zip(frames, results)):
        want = _expect(refs["a" if i % 2 else "b"], {"x": f})["y"]
        np.testing.assert_array_equal(r["y"], want)
    m = rep["measured"]
    assert m["completed"] == m["submitted"] == len(frames)
    assert rep["apps"]["a"]["served"] + rep["apps"]["b"]["served"] \
        == len(frames)
    assert sum(rep["buckets"].values()) == (rep["apps"]["a"]["batches"]
                                           + rep["apps"]["b"]["batches"])


@pytest.mark.parametrize("name", ["unsharp_mask", "optical_flow_lk"])
def test_engine_matches_the_jax_engine(name):
    """The same frames through the JAX engine (``xla``) and the port's
    (``torch`` on the CPU), interleaved two apps deep."""
    from repro.core import apps as japps
    from repro.runtime import StreamEngine as JaxEngine
    h, w = 48, 256
    rng = np.random.default_rng(7)
    reqs = [{c.name: rng.normal(size=c.shape).astype(np.float32)
             for c in tapps.build_app(name, h, w).graph_inputs}
            for _ in range(6)]
    with StreamEngine(backend="torch", max_batch=4, **CPU) as eng:
        g = tapps.build_app(name, h, w)
        got = [r.result(timeout=T)
               for r in [eng.submit(g, x) for x in reqs]]
    with JaxEngine(backend="xla", max_batch=4) as jeng:
        jg = japps.APPS[name][0](h, w)
        want = [r.result(timeout=120)
                for r in [jeng.submit(jg, x) for x in reqs]]
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            ref = np.asarray(b[k])
            tol = 1e-5 * np.abs(ref).max() + 1e-5 * np.abs(ref)
            assert np.all(np.abs(a[k] - ref) <= tol), k


# ----------------------------------------------------------------------
# compile cache
# ----------------------------------------------------------------------
def test_cache_structural_hit_across_fresh_graphs():
    cache = CompileCache()
    a1 = cache.get(_diamond(8, 128, name="g1"), backend="torch", **CPU)
    a2 = cache.get(_diamond(8, 128, name="g2"), backend="torch", **CPU)
    assert a1 is a2
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    a3 = cache.get(_diamond(16, 128, name="g3"), backend="torch", **CPU)
    assert a3 is not a1 and cache.stats.misses == 2
    cache.get(_diamond(8, 128), backend="torch_staged", **CPU)
    assert cache.stats.misses == 3


def test_cache_alias_survives_in_place_canonicalization():
    cache = CompileCache()
    g = _diamond(8, 128)
    pre = g.signature()
    cache.get(g, backend="torch", **CPU)
    assert g.signature() != pre              # canonicalized in place
    cache.get(g, backend="torch", **CPU)     # same object: no new event
    assert cache.stats.misses == 1 and cache.stats.hits == 0
    assert cache.stats.requests == 2
    cache.get(_diamond(8, 128), backend="torch", **CPU)
    assert cache.stats.misses == 1 and cache.stats.hits == 1


def test_cache_lru_eviction():
    cache = CompileCache(maxsize=2)
    for h in (8, 16, 24):
        cache.get(_diamond(h, 128), backend="torch", **CPU)
    assert cache.stats.evictions > 0
    assert len(cache) <= 2


def test_cache_hit_rate_counts_compile_events_not_requests():
    cache = CompileCache()
    graphs = [_diamond(name=f"g{i}") for i in range(5)]
    apps = [cache.get(g, backend="torch", **CPU) for g in graphs]
    assert all(a is apps[0] for a in apps)
    assert cache.stats.misses == 1 and cache.stats.hits == 4
    for _ in range(3):
        for g in graphs:
            cache.get(g, backend="torch", **CPU)
    assert cache.stats.requests == 20
    assert cache.stats.misses == 1 and cache.stats.hits == 4
    assert cache.stats.as_dict()["hit_rate"] == pytest.approx(0.8)


# ----------------------------------------------------------------------
# backpressure, admission, shutdown
# ----------------------------------------------------------------------
def test_bounded_queue_backpressure():
    g = _diamond()
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_queue=2, max_batch=2,
                       autostart=False, **CPU)
    try:
        eng.submit(g, {"x": x}, block=False)
        eng.submit(g, {"x": x}, block=False)
        with pytest.raises(QueueFullError):
            eng.submit(g, {"x": x}, block=False)
        eng.start()
        h = eng.submit(g, {"x": x}, timeout=T)
        assert h.result(timeout=T)["y"].shape == (8, 128)
    finally:
        eng.close()


def test_engine_rejects_after_close():
    eng = StreamEngine(backend="torch", autostart=False, **CPU)
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit(_diamond(), {"x": np.zeros((8, 128), np.float32)})


def test_engine_rejects_bad_input_at_submit():
    g = _diamond()
    (x,) = _frames(1)
    with StreamEngine(backend="torch", max_batch=2, **CPU) as eng:
        ok = eng.submit(g, {"x": x})
        with pytest.raises(ValueError, match="expected shape"):
            eng.submit(g, {"x": np.zeros((4, 4), np.float32)})
        with pytest.raises(ValueError, match="missing graph input"):
            eng.submit(g, {"img": np.zeros((8, 128), np.float32)})
        assert ok.result(timeout=T)["y"].shape == (8, 128)


def test_engine_defaults_to_the_card_and_refuses_unported_options():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        StreamEngine(autostart=False)
    with pytest.raises(NotPortedError, match="A6"):
        StreamEngine(replicas=2, autostart=False, **CPU)
    with pytest.raises(NotPortedError, match="A5"):
        StreamEngine(sentinel=True, autostart=False, **CPU)
    with pytest.raises(NotPortedError, match="A6"):
        MicroBatcher(max_batch=4, replicas=2)
    app = compile_graph(_diamond(), backend="torch", **CPU)
    eng = StreamEngine(backend="torch", autostart=False, **CPU)
    try:
        eng.submit(app, {"x": np.zeros((8, 128), np.float32)}).cancel()
    finally:
        eng.close(wait=False)


def test_close_drains_inflight_without_drops():
    n = 24
    g = _diamond()
    frames = _frames(n)
    eng = StreamEngine(backend="torch", max_batch=4, max_queue=64, **CPU)
    handles = [eng.submit(g, {"x": f}) for f in frames]
    eng.close(wait=True)
    results = [h.result(timeout=1) for h in handles]
    ref_graph = _ref(eng, g)
    for f, r in zip(frames, results):
        np.testing.assert_array_equal(r["y"],
                                      _expect(ref_graph, {"x": f})["y"])
    m = eng.report()["measured"]
    assert m["completed"] == n and m["submitted"] == n
    with pytest.raises(RuntimeError):
        eng.submit(g, {"x": frames[0]})


def test_mixed_signature_interleaved_bit_exact():
    n = 16
    ga, gb = _diamond(name="a"), _pointwise(name="b")
    fa, fb = _frames(n, seed=1), _frames(n, seed=2)
    with StreamEngine(backend="torch", max_batch=4, max_queue=64,
                      **CPU) as eng:
        handles = []
        for xa, xb in zip(fa, fb):
            handles.append(("a", xa, eng.submit(ga, {"x": xa})))
            handles.append(("b", xb, eng.submit(gb, {"x": xb})))
        results = [(k, x, h.result(timeout=T)) for k, x, h in handles]
        rep = eng.report()
    refs = {"a": _ref(eng, ga), "b": _ref(eng, gb)}
    for k, x, r in results:
        np.testing.assert_array_equal(r["y"], _expect(refs[k], {"x": x})["y"])
    assert rep["apps"]["a"]["served"] == n
    assert rep["apps"]["b"]["served"] == n
    assert rep["cache"]["misses"] == 2


def test_admission_sheds_per_app_not_globally():
    hot, cold = _diamond(name="hot"), _pointwise(name="cold")
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_queue=2, autostart=False, **CPU)
    try:
        for _ in range(2):
            eng.submit(hot, {"x": x}, block=False)
        with pytest.raises(QueueFullError):
            eng.submit(hot, {"x": x}, block=False)
        with pytest.raises(QueueFullError):
            eng.submit(hot, {"x": x}, timeout=0.01)
        eng.submit(cold, {"x": x}, block=False)
        rep = eng.report()
        assert rep["apps"]["hot"]["shed"] == 2
        assert rep["apps"]["cold"]["shed"] == 0
        assert rep["measured"]["shed"] == 2
    finally:
        eng.close(wait=False)


def test_max_pending_bounds_total_across_apps():
    hot, cold = _diamond(name="hot"), _pointwise(name="cold")
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_queue=8, max_pending=2,
                       autostart=False, **CPU)
    try:
        eng.submit(hot, {"x": x}, block=False)
        eng.submit(cold, {"x": x}, block=False)
        with pytest.raises(QueueFullError):
            eng.submit(cold, {"x": x}, block=False)
    finally:
        eng.close(wait=False)


# ----------------------------------------------------------------------
# cancellation
# ----------------------------------------------------------------------
def test_cancel_frees_queue_slot_immediately():
    g = _diamond()
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_queue=2, max_batch=2,
                       autostart=False, **CPU)
    try:
        h1 = eng.submit(g, {"x": x}, block=False)
        h2 = eng.submit(g, {"x": x}, block=False)
        with pytest.raises(QueueFullError):
            eng.submit(g, {"x": x}, block=False)
        assert h1.cancel() is True
        h3 = eng.submit(g, {"x": x}, block=False)
        assert h1.cancelled()
        with pytest.raises(CancelledError):
            h1.result(timeout=1)
        assert h1.cancel() is False
        eng.start()
        np.testing.assert_array_equal(h2.result(timeout=T)["y"],
                                      h3.result(timeout=T)["y"])
        m = eng.report()["measured"]
        assert m["cancelled"] == 1 and m["completed"] == 2
    finally:
        eng.close()


def test_result_timeout_then_cancel():
    g = _diamond()
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", autostart=False, **CPU)
    try:
        h = eng.submit(g, {"x": x})
        with pytest.raises(TimeoutError):
            h.result(timeout=0.05)
        assert not h.done()
        assert h.cancel() is True
        with pytest.raises(CancelledError):
            h.result(timeout=1)
        assert isinstance(h.exception(timeout=1), CancelledError)
    finally:
        eng.close()


def test_cancel_of_inflight_request_discards_its_row():
    g = _diamond()
    frames = _frames(2)
    eng = StreamEngine(backend="torch", max_batch=2, autostart=False, **CPU)
    try:
        handles = [eng.submit(g, {"x": f}) for f in frames]
        batch = eng._form_batch()
        assert len(batch) == 2
        assert handles[1].cancel() is True
        eng._dispatch(batch)
        eng._retire(eng._pool.oldest())
        np.testing.assert_array_equal(
            handles[0].result(timeout=1)["y"],
            _expect(_ref(eng, g), {"x": frames[0]})["y"])
        with pytest.raises(CancelledError):
            handles[1].result(timeout=1)
        m = eng.report()["measured"]
        assert m["completed"] == 1 and m["cancelled"] == 1
    finally:
        eng.close(wait=False)


def test_a_failed_launch_fails_its_batch_not_the_engine():
    """A batch whose launch raises fails its own requests with the
    error; the engine serves the next batch."""
    g = _diamond()
    frames = _frames(3)
    eng = StreamEngine(backend="torch", max_batch=2, autostart=False, **CPU)
    try:
        handles = [eng.submit(g, {"x": f}) for f in frames[:2]]
        real = eng._batcher.launch

        def broken(*a, **k):
            raise RuntimeError("launch failed")

        eng._batcher.launch = broken
        eng._dispatch(eng._form_batch())
        for h in handles:
            with pytest.raises(RuntimeError, match="launch failed"):
                h.result(timeout=1)
        eng._batcher.launch = real
        eng.start()
        h = eng.submit(g, {"x": frames[2]})
        np.testing.assert_array_equal(
            h.result(timeout=T)["y"],
            _expect(_ref(eng, g), {"x": frames[2]})["y"])
    finally:
        eng.close()


# ----------------------------------------------------------------------
# weighted fairness and the formation budget (white-box)
# ----------------------------------------------------------------------
def test_deficit_weighted_round_robin_formation():
    hot, cold = _diamond(name="hot"), _pointwise(name="cold")
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_batch=2, max_queue=64,
                       app_weights={"hot": 2.0, "cold": 1.0},
                       autostart=False, **CPU)
    try:
        for _ in range(12):
            eng.submit(hot, {"x": x})
        for _ in range(6):
            eng.submit(cold, {"x": x})
        formed = []
        for _ in range(9):
            batch = eng._form_batch()
            assert len(batch) == 2
            formed.append(batch[0].app.graph.name)
        assert formed.count("hot") == 6 and formed.count("cold") == 3
        assert "cold" in formed[:3]
        rep = eng.report()
        assert rep["apps"]["hot"]["batches"] == 6
        assert rep["apps"]["cold"]["batches"] == 3
        assert rep["apps"]["hot"]["served"] == 12
    finally:
        eng.close(wait=False)


def test_set_app_weight_applies_to_live_queue():
    g = _diamond(name="hot")
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", autostart=False, **CPU)
    try:
        eng.submit(g, {"x": x})
        eng.set_app_weight("hot", 3.0)
        assert eng.report()["apps"]["hot"]["weight"] == 3.0
    finally:
        eng.close(wait=False)


def test_form_budget_adapts_and_clamps():
    eng = StreamEngine(backend="torch", linger=0.002, autostart=False, **CPU)
    try:
        assert eng._form_budget() == 0.002
        eng._service_ewma = 0.01
        assert eng._form_budget() == pytest.approx(0.005)
        eng._service_ewma = 10.0
        assert eng._form_budget() == _BUDGET_MAX_S
        eng._service_ewma = 1e-9
        assert eng._form_budget() == _BUDGET_MIN_S
    finally:
        eng.close(wait=False)
    eng = StreamEngine(backend="torch", latency_budget=0.5, autostart=False,
                       **CPU)
    try:
        eng._service_ewma = 1e-9
        assert eng._form_budget() == 0.5
    finally:
        eng.close(wait=False)


def test_formation_is_work_conserving_when_idle():
    g = _diamond()
    (x,) = _frames(1)
    eng = StreamEngine(backend="torch", max_batch=8, latency_budget=10.0,
                       autostart=False, **CPU)
    try:
        eng.submit(g, {"x": x})
        t0 = time.perf_counter()
        batch = eng._form_batch()
        assert len(batch) == 1
        assert time.perf_counter() - t0 < 1.0
    finally:
        eng.close(wait=False)


# ----------------------------------------------------------------------
# async launch handles and the micro-batcher
# ----------------------------------------------------------------------
def test_compiled_app_async_launch():
    app = compile_graph(_diamond(), backend="torch", **CPU)
    (x,) = _frames(1)
    h = app.launch(x=x)
    out = h.result()
    assert h.done()
    assert torch.equal(out["y"], app(x=x)["y"])


def test_bucket_is_next_pow2_capped_at_max_batch():
    mb = MicroBatcher(max_batch=8)
    assert [mb.bucket(n) for n in (1, 2, 3, 4, 5, 7, 8)] \
        == [1, 2, 4, 4, 8, 8, 8]
    with pytest.raises(ValueError):
        mb.bucket(0)
    assert MicroBatcher(max_batch=6).bucket(5) == 6


@pytest.mark.parametrize("backend", ["torch", "cuda_stream"])
def test_micro_batcher_pad_and_slice_bit_exact(backend):
    app = compile_graph(_diamond(), backend=backend, **CPU)
    mb = MicroBatcher(max_batch=8)
    reqs = [_Req(x) for x in _frames(5)]
    y = mb.launch(app, reqs, pad_to=8)["y"]
    assert y.shape == (8, 8, 128)
    for i, r in enumerate(reqs):
        assert torch.equal(y[i], app(x=r.inputs["x"])["y"])
    with pytest.raises(ValueError):
        mb.launch(app, [_Req(np.zeros((8, 128), np.float32))] * 9)


def test_launch_pads_to_bucket_and_counts_it():
    app = compile_graph(_diamond(), backend="torch", **CPU)
    mb = MicroBatcher(max_batch=8)
    reqs = [_Req(x) for x in _frames(5)]
    y3 = mb.launch(app, reqs[:3])["y"]
    y5 = mb.launch(app, reqs)["y"]
    assert y3.shape[0] == 4 and y5.shape[0] == 8
    assert mb.bucket_launches == {4: 1, 8: 1}
    for i, r in enumerate(reqs):
        assert torch.equal(y5[i], app(x=r.inputs["x"])["y"])


def test_staging_buffers_are_reused_and_stay_bit_exact():
    app = compile_graph(_diamond(), backend="torch", **CPU)
    mb = MicroBatcher(max_batch=4, staging_depth=2)
    ids = []
    for k in range(6):
        reqs = [_Req(x) for x in _frames(4, seed=10 + k)]
        y = mb.launch(app, reqs)["y"]
        for i, r in enumerate(reqs):
            assert torch.equal(y[i], app(x=r.inputs["x"])["y"])
        ids.append(id(mb._staging[(app.signature(), 4)][0].tensors[0]))
    assert len(set(ids)) == 1                # one allocation per rotation
    assert mb.bucket_launches == {4: 6}
    with pytest.raises(ValueError, match="expected shape"):
        mb.stack(app, [_Req(np.zeros((4, 4), np.float32))])


# ----------------------------------------------------------------------
# slots and telemetry
# ----------------------------------------------------------------------
def test_slot_pool_fifo_admission_and_retirement():
    pool = SlotPool(2)
    for item in "abcd":
        pool.submit(item)
    assert [i for _, i in pool.admit()] == ["a", "b"]
    oldest = pool.oldest()
    assert pool.retire(oldest) == "a"
    assert pool.admit() == [(oldest, "c")]
    assert pool.slots[pool.oldest()] == "b"
    pool.retire(pool.oldest())
    pool.retire(pool.oldest())
    assert pool.finished == ["a", "b", "c"]
    with pytest.raises(ValueError):
        pool.retire(0)
    assert pool.busy


def test_telemetry_report_shapes():
    t = Telemetry()
    t.observe_submit(0)
    t.observe_batch(4)
    for ms in (1.0, 2.0, 3.0):
        t.observe_completion(ms * 1e-3)
    snap = t.snapshot()
    assert snap["completed"] == 3
    assert snap["latency_p50_ms"] == pytest.approx(2.0)
    app = compile_graph(_diamond(), backend="torch", **CPU)
    rep = t.report(modeled={"diamond": modeled_latency(app, 16)})
    assert set(rep) == {"measured", "modeled"}
    mod = rep["modeled"]["diamond"]
    assert mod["speedup"] > 1.0 and "dataflow_sim" in mod


def test_report_breaks_down_hot_path_phases():
    n = 16
    g = _diamond()
    with StreamEngine(backend="torch", max_batch=4, max_queue=64,
                      **CPU) as eng:
        handles = [eng.submit(g, {"x": f}) for f in _frames(n)]
        for h in handles:
            h.result(timeout=T)
        rep = eng.report()
    phases = rep["measured"]["phases"]
    assert set(PHASES) <= set(phases)
    assert phases["queue_wait"]["count"] == n
    batches = phases["launch"]["count"]
    assert batches >= 1 and phases["readback"]["count"] == batches
    for p in PHASES:
        assert phases[p]["mean_ms"] >= 0.0 and phases[p]["p99_ms"] >= 0.0
    assert rep["buckets"] and all(1 <= w <= 4 for w in rep["buckets"])
    assert sum(rep["buckets"].values()) == batches


def test_telemetry_bulk_ingest_and_reset():
    t = Telemetry()
    now = time.perf_counter()
    t.observe_batches([
        (now, 4, {"launch": 1e-3, "queue_wait": [1e-4] * 4},
         [2e-3] * 4, 5e-3),
        (now + 0.1, 2, {"launch": 2e-3}, [3e-3] * 2, 4e-3),
    ])
    t.observe_submits(6, [0, 1, 2, 3, 4, 5])
    snap = t.snapshot()
    assert snap["completed"] == 6 and snap["submitted"] == 6
    assert snap["batch_size_mean"] == pytest.approx(3.0)
    assert snap["phases"]["launch"]["count"] == 2
    assert snap["service_ewma_ms"] > 0 and snap["throughput_rps"] > 0
    t.reset()
    snap = t.snapshot()
    assert snap["completed"] == 0 and snap["phases"] == {}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_engine_serves_40_distinct_requests_bit_exactly_on_card():
    """``cuda_stream`` with ``inflight=2``: every request's frame
    differs, so a staging rotation rewritten before its batch was read
    back would show in some result.  Each result equals the app's
    single-frame launch on the card (atol 0), and the launch count is
    one per group per batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))
    rng = np.random.default_rng(11)
    names = ("unsharp_mask", "optical_flow_lk")
    graphs = {n: tapps.build_app(n, 120, 256) for n in names}
    reqs = [(names[i % 2],
             {c.name: rng.normal(size=c.shape).astype(np.float32)
              for c in graphs[names[i % 2]].graph_inputs})
            for i in range(40)]
    with StreamEngine(max_batch=4, inflight=2, max_queue=64) as eng:
        for n, g in graphs.items():          # build before counting
            app = eng.cache.get(g, backend="cuda_stream", device=eng.device)
            app(**reqs[names.index(n)][1])
        torch.cuda.synchronize()
        before = stream_group.launches
        handles = [(n, x, eng.submit(graphs[n], x)) for n, x in reqs]
        results = [(n, x, h.result(timeout=T)) for n, x, h in handles]
        rep = eng.report()
        launched = stream_group.launches - before
        apps = {n: eng.cache.get(g, backend="cuda_stream",
                                 device=eng.device)
                for n, g in graphs.items()}
    for n, x, r in results:
        want = apps[n](**x)
        for k, v in want.items():
            np.testing.assert_array_equal(r[k], v.cpu().numpy())
    assert rep["measured"]["completed"] == 40
    groups = sum(rep["apps"][n]["batches"] * len(apps[n].schedule.groups)
                 for n in names)
    assert launched == groups
