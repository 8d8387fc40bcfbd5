"""Replication in the port: the replica mesh, the row-halo exchange,
``replicate_app``, ``compile_graph(mesh=)``, the replicated
``MicroBatcher`` and ``StreamEngine(replicas=)``, and the drift
sentinel's device-timed ``launch`` rows.

Twins of the reference's replication tests (``tests/test_parallel.py``,
``tests/test_backends.py`` and ``tests/test_tuning.py``) on the CPU at
planes of at most 96x256.  The reference runs k replicas on forced CPU
host devices; the port runs them on ``devices=["cpu"] * k``, one
process driving every replica.  Against the port's single-device app a
replicated app is bit-exact (atol 0) at k = 1, 2, 3 and 4; against the
JAX package's ``replicate_app(..., backend="xla")`` on the same numpy
inputs it agrees within 1e-5 x max|ref| + 1e-5 x |ref| (each case
records its max abs error in ``user_properties``).  The ``gpu`` tests
skip without a card.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro_torch.runtime.engine as engine_mod                # noqa: E402
import repro_torch.tune.search as search                       # noqa: E402
from repro_torch.backends import (TORCH, UnsupportedBackendError,  # noqa: E402
                                  resolve)
from repro_torch.core import DataflowGraph, GraphError, compile_graph  # noqa: E402
from repro_torch.core import apps as tapps                     # noqa: E402
from repro_torch.core.vectorize import H100                    # noqa: E402
from repro_torch.device import DeviceUnavailableError          # noqa: E402
from repro_torch.kernels import build                          # noqa: E402
from repro_torch.kernels.launch_gate import LaunchGate         # noqa: E402
from repro_torch.kernels.stream_group import stream_group      # noqa: E402
from repro_torch.obs.drift import DriftLog, DriftRow           # noqa: E402
from repro_torch.parallel import (UNROUTED_COMPILE_KWARGS,     # noqa: E402
                                  ReplicaMesh, graph_input_halo,
                                  halo_exchange_rows, replica_mesh,
                                  replicate_app, replication_kwarg_routing)
from repro_torch.runtime import MicroBatcher, StreamEngine     # noqa: E402
from repro_torch.tune import TuningCache, calibrate            # noqa: E402

try:                                 # the card's machine has no JAX
    from repro.core import apps as japps
    from repro.core.compiler import compile_graph as jcompile
    from repro.parallel import replicate as jreplicate
except ImportError:
    japps = None

H, W = 96, 256
T = 60                   # seconds: every result() has a timeout
CHIP_APPS = ("filter_chain", "unsharp_mask", "harris", "optical_flow_lk")
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_drift_h100.jsonl")


def _cpu(k):
    return ["cpu"] * k


def _inputs(name, h=H, w=W, seed=0):
    g = tapps.build_app(name, h, w)
    rng = np.random.default_rng(seed)
    return {c.name: rng.standard_normal(c.shape).astype(np.float32)
            for c in g.graph_inputs}


def _needs_jax():
    if japps is None:
        pytest.skip("needs JAX and the repro package")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


# ----------------------------------------------------------------------
# the mesh and the exchange
# ----------------------------------------------------------------------
def test_replica_mesh_on_the_cpu_and_explicit_devices():
    m = replica_mesh(3, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.shape == {"replica": 3} and m.size == 3
    assert replica_mesh(device="cpu").size == 1
    # an explicit list may repeat a device: one card stands for k replicas
    m = replica_mesh(devices=["cpu", "cpu"], axis="data")
    assert m.axis_names == ("data",) and m.size == 2
    with pytest.raises(ValueError, match="only 2 devices"):
        replica_mesh(3, devices=_cpu(2))
    with pytest.raises(ValueError, match=">= 1"):
        replica_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="one type"):
        ReplicaMesh((torch.device("cpu"), torch.device("meta")))


def test_replica_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        replica_mesh(2)
    with pytest.raises(DeviceUnavailableError):
        replica_mesh(devices=["cuda:0"])


def test_halo_exchange_rows_neighbours_and_zero_edges():
    x = torch.arange(12 * 4, dtype=torch.float32).reshape(12, 4)
    shards = list(x.split(4))
    ext = halo_exchange_rows(shards, 2)
    assert [tuple(e.shape) for e in ext] == [(8, 4)] * 3
    padded = torch.cat([torch.zeros(2, 4), x, torch.zeros(2, 4)])
    for j, e in enumerate(ext):
        assert torch.equal(e, padded[4 * j:4 * j + 8])
    assert halo_exchange_rows(shards, 0)[1] is shards[1]
    with pytest.raises(ValueError, match="fewer than"):
        halo_exchange_rows(shards, 5)


# ----------------------------------------------------------------------
# replication: halo analysis, rejections, single replica (bit-exact)
# ----------------------------------------------------------------------
def test_graph_input_halo_accumulates_across_groups():
    halos = graph_input_halo(tapps.build_app("filter_chain", H, W))
    assert list(halos.values()) == [(3, 3)]


@pytest.mark.parametrize("name", sorted(tapps.APPS))
def test_graph_input_halo_matches_jax(name):
    _needs_jax()
    ours = {c.name: h for c, h in
            graph_input_halo(tapps.build_app(name, H, W)).items()}
    ref = {c.name: h for c, h in
           jreplicate.graph_input_halo(japps.build_app(name, H, W)).items()}
    assert ours == ref


def test_replicate_rejects_mixed_shapes():
    g = DataflowGraph("mixed")
    x = g.input("x", (32, 128))
    g.output(g.reduce(x, lambda v: v.sum(), out_shape=()), "total")
    with pytest.raises(GraphError, match="2-D plane"):
        replicate_app(g, 1, backend="torch", devices=_cpu(1))


def test_replicate_rejects_opaque_stages():
    """custom/reduce stages could read across the row cut; no halo
    provision or masking makes that correct, so reject loudly."""
    g = DataflowGraph("opaque")
    x = g.input("x", (32, 128))
    y = g.custom([x], lambda v: v + 1.0, [(32, 128)], name="addone")[0]
    g.output(g.stencil(y, (3, 3), lambda p: p.mean(0)), "out")
    with pytest.raises(GraphError, match="opaque"):
        replicate_app(g, 1, backend="torch", devices=_cpu(1))


def test_replicate_rejects_nondividing_height_and_large_halo():
    with pytest.raises(GraphError, match="divide"):
        replicate_app(tapps.build_app("square", 30, 128), 4,
                      backend="torch", devices=_cpu(4))
    with pytest.raises(GraphError, match="does not fit"):
        replicate_app(tapps.build_app("filter_chain", 12, 128), 4,
                      backend="torch", devices=_cpu(4))


@pytest.mark.parametrize("backend", ["torch", "torch_staged", "cuda_stream"])
@pytest.mark.parametrize("name", ["filter_chain", "gaussian_blur"])
def test_replicated_single_device_bit_exact(backend, name):
    """1 replica: the same halo-exchange path, with zero halos, must
    reproduce the plain app bit for bit."""
    app = compile_graph(tapps.build_app(name, H, W), backend=backend,
                        device="cpu")
    rep = replicate_app(app)
    assert rep.n_replicas == 1 and rep.halo_rows > 0
    x = _inputs(name)
    assert torch.equal(app(**x)["out"], rep(**x)["out"])


def test_replicated_app_launch_and_describe():
    rep = replicate_app(tapps.build_app("filter_chain", H, W),
                        backend="torch", devices=_cpu(1))
    h = rep.launch(**_inputs("filter_chain"))
    assert h.done()
    assert h.result()["out"].shape == (H, W)
    text = rep.describe()
    assert "1 replicas" in text and "halo rows" in text


# ----------------------------------------------------------------------
# replication over k CPU replicas (bit-exact against the single device)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("name", CHIP_APPS)
def test_replicated_k_replicas_bit_exact(name, k):
    """k = 3 has a middle shard between two edges: all three
    ``valid_rows`` variants run."""
    app = compile_graph(tapps.build_app(name, H, W), device="cpu")
    rep = replicate_app(app, k, devices=_cpu(k))
    assert rep.n_replicas == k and len(rep.kernels) == min(k, 3)
    x = _inputs(name, seed=k)
    want = app(**x)
    got = rep(**x)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("k", [2, 4])
def test_replicated_torch_backend_bit_exact(k):
    app = compile_graph(tapps.build_app("unsharp_mask", H, W),
                        backend="torch", device="cpu")
    rep = replicate_app(app, k, devices=_cpu(k))
    x = _inputs("unsharp_mask", seed=7)
    assert torch.equal(rep(**x)["out"], app(**x)["out"])


@functools.lru_cache(maxsize=None)
def _jax_replicated(name):
    app = jcompile(japps.build_app(name, H, W), backend="xla")
    rep = jreplicate.replicate_app(app, 1, backend="xla")
    return {k: np.asarray(v) for k, v in rep(**_inputs(name)).items()}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", CHIP_APPS)
def test_replicated_matches_jax(name, k, request):
    _needs_jax()
    rep = replicate_app(tapps.build_app(name, H, W), k, devices=_cpu(k))
    got = rep(**_inputs(name))
    ref = _jax_replicated(name)
    worst = 0.0
    for n, r in ref.items():
        err = np.abs(got[n].numpy() - r)
        scale = float(np.abs(r).max())
        assert (err <= 1e-5 * scale + 1e-5 * np.abs(r)).all(), (
            f"{name}/{n}: max abs err {err.max():.3e}")
        worst = max(worst, float(err.max()))
    request.node.user_properties.append(("max_abs_err", worst))


def test_compile_graph_mesh_runs_replicated():
    mesh = replica_mesh(4, axis="data", device="cpu")
    app = compile_graph(tapps.build_app("harris", H, W), device="cpu",
                        mesh=mesh)
    plain = compile_graph(tapps.build_app("harris", H, W), device="cpu")
    x = _inputs("harris", seed=3)
    assert torch.equal(app(**x)["out"], plain(**x)["out"])
    assert app.mesh is mesh and app.replicated.n_replicas == 4
    assert app.batch_fn is None
    # one lowering: the schedule and kernels are the replicas' (local
    # extended plane), the buffers the global plane's
    assert app.schedule is app.replicated.schedule
    assert app.kernels == app.replicated.kernels
    hy = app.replicated.halo_rows
    assert app.schedule.graph.graph_inputs[0].shape == (H // 4 + 2 * hy, W)
    assert {b.shape for b in app.buffers} == {(H, W)}
    with pytest.raises(ValueError, match="not an axis"):
        compile_graph(tapps.build_app("harris", H, W), device="cpu",
                      mesh=replica_mesh(2, device="cpu"))
    with pytest.raises(GraphError, match="divide"):
        compile_graph(tapps.build_app("harris", 30, W), device="cpu",
                      mesh=replica_mesh(4, axis="data", device="cpu"))


# ----------------------------------------------------------------------
# kwarg routing (twins of tests/test_backends.py) and tuning
# ----------------------------------------------------------------------
def test_replication_routing_covers_every_compile_kwarg():
    all_kwargs = set(
        inspect.signature(compile_graph).parameters) - {"graph", "backend"}
    known, sched, lower = replication_kwarg_routing()
    unclassified = all_kwargs - known - UNROUTED_COMPILE_KWARGS
    assert not unclassified, sorted(unclassified)
    assert known >= {"canonicalize", "strict", "passes", "spec",
                     "vector_factor", "interpret", "tune", "tune_cache",
                     "max_tile", "calibrate"}
    assert "device" in UNROUTED_COMPILE_KWARGS and "interpret" in lower
    assert sched and lower


def test_replicate_app_rejects_unknown_kwargs():
    with pytest.raises(TypeError, match="unsupported compile kwargs"):
        replicate_app(tapps.build_app("square", H, W), 1, bogus_option=1)
    with pytest.raises(TypeError, match="device"):
        replicate_app(tapps.build_app("square", H, W), 1, device="cpu")


def test_replicate_requires_replication_capability():
    for name in ("torch", "torch_staged", "cuda_stream"):
        assert "replication" in resolve(name).capabilities
    gated = dataclasses.replace(TORCH, name="no_repl",
                                capabilities=frozenset({"tuning"}))
    with pytest.raises(UnsupportedBackendError) as ei:
        replicate_app(tapps.build_app("square", H, W), 1, backend=gated,
                      devices=_cpu(1))
    assert "replication" in ei.value.missing


def test_replicate_tune_excludes_max_tile_and_vector_factor():
    app = compile_graph(tapps.build_app("filter_chain", 32, 128),
                        device="cpu")
    with pytest.raises(TypeError, match="mutually exclusive"):
        replicate_app(app, tune="auto", max_tile=(64, 128))
    with pytest.raises(TypeError, match="mutually exclusive"):
        replicate_app(app, tune="auto", vector_factor=2)


def test_replicate_app_picks_up_tuning(tmp_path):
    cache = TuningCache(str(tmp_path))
    app = compile_graph(tapps.build_app("filter_chain", 32, 128),
                        device="cpu")
    rapp = replicate_app(app, tune="auto", tune_cache=cache)
    x = np.random.default_rng(0).normal(size=(32, 128)).astype(np.float32)
    assert torch.equal(rapp(img=x)["out"], app(img=x)["out"])
    assert len(cache) >= 1                 # the local extended plane's entry
    assert ("via measured" in rapp.describe()
            or "via cache" in rapp.describe())
    # second replication: served from the persistent cache
    calls = {"n": 0}
    real = search.default_measure

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    search.default_measure = counting
    try:
        rapp2 = replicate_app(app, tune="auto", tune_cache=cache)
    finally:
        search.default_measure = real
    assert calls["n"] == 0
    assert "via cache" in rapp2.describe()


# ----------------------------------------------------------------------
# the replicated farm: MicroBatcher and StreamEngine
# ----------------------------------------------------------------------
class _Req:
    def __init__(self, inputs):
        self.inputs = inputs


def test_microbatcher_replicas_must_divide():
    with pytest.raises(ValueError, match="divide evenly"):
        MicroBatcher(max_batch=6, replicas=4)
    with pytest.raises(ValueError, match=">= 1"):
        MicroBatcher(max_batch=4, replicas=0)


def test_microbatcher_refuses_apps_it_cannot_split():
    reqs = [_Req(_inputs("filter_chain", 32, 128))]
    app = compile_graph(tapps.build_app("filter_chain", 32, 128),
                        device="cpu")
    mb = MicroBatcher(max_batch=4, replicas=2, devices=["meta", "meta"])
    with pytest.raises(ValueError, match="compiled for cpu"):
        mb.launch(app, reqs)
    meshed = compile_graph(tapps.build_app("filter_chain", 32, 128),
                           device="cpu",
                           mesh=replica_mesh(2, axis="data", device="cpu"))
    with pytest.raises(ValueError, match="no batched entry"):
        MicroBatcher(max_batch=4).launch(meshed, reqs)


@pytest.mark.parametrize("backend", ["torch", "cuda_stream"])
def test_replicated_microbatcher_splits_rows(backend):
    app = compile_graph(tapps.build_app("filter_chain", 32, 128),
                        backend=backend, device="cpu")
    mb = MicroBatcher(max_batch=8, replicas=2, devices=_cpu(2))
    reqs = [_Req(_inputs("filter_chain", 32, 128, seed=s)) for s in range(3)]
    out = mb.launch(app, reqs)["out"]
    assert isinstance(out, list) and [o.shape[0] for o in out] == [2, 2]
    rows = torch.cat(out)
    for i, r in enumerate(reqs):
        assert torch.equal(rows[i], app(**r.inputs)["out"])
    assert mb.bucket_launches == {4: 1}
    assert [mb.bucket(n) for n in (1, 3, 5, 8)] == [2, 4, 8, 8]


def test_engine_replicas_bit_exact_on_cpu_replicas():
    g = tapps.build_app("filter_chain", 32, 128)
    app = compile_graph(tapps.build_app("filter_chain", 32, 128),
                        backend="torch", device="cpu")
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(32, 128)).astype(np.float32) for _ in range(12)]
    with StreamEngine(backend="torch", max_batch=8, replicas=4,
                      device="cpu") as eng:
        assert eng.mesh.size == 4
        handles = [eng.submit(g, {"img": x}) for x in xs]
        outs = [h.result(timeout=T)["out"] for h in handles]
        rep = eng.report()
    for x, y in zip(xs, outs):
        np.testing.assert_array_equal(y, app(img=x)["out"].numpy())
    m = rep["measured"]
    assert m["replicas"] == 4
    assert m["throughput_per_replica_rps"] * 4 == pytest.approx(
        m["throughput_rps"])
    mod = next(iter(rep["modeled"].values()))
    assert mod["replica_scaling_modeled"] > 1.0


# ----------------------------------------------------------------------
# C1: the drift sentinel's launch rows time the launches alone
# ----------------------------------------------------------------------
_SLOW_S = 0.05


def test_launch_rows_exclude_stack_and_readback(tmp_path, monkeypatch):
    """With 50 ms slept in each batch's staging and in its readback, a
    ``launch`` row's ``measured_s`` is the host time around the batched
    entry alone, while the service time keeps both sleeps."""
    real_stage = MicroBatcher._stage
    real_to_host = engine_mod._to_host

    def slow_stage(self, *a, **kw):
        time.sleep(_SLOW_S)
        return real_stage(self, *a, **kw)

    def slow_to_host(out):
        time.sleep(_SLOW_S)
        return real_to_host(out)

    monkeypatch.setattr(MicroBatcher, "_stage", slow_stage)
    monkeypatch.setattr(engine_mod, "_to_host", slow_to_host)
    g = tapps.build_app("square", 8, 128)
    path = str(tmp_path / "drift.jsonl")
    with StreamEngine(backend="torch", max_batch=2, drift=path,
                      device="cpu") as eng:
        for i in range(4):
            eng.submit(g, {"img": np.full((8, 128), i, np.float32)}
                       ).result(timeout=T)
        m = eng.report()["measured"]
    rows = DriftLog(path).rows()
    launch = [r for r in rows if r.kind == "launch"]
    compile_ = [r for r in rows if r.kind == "compile"]
    assert launch and compile_
    assert all(0 < r.measured_s < _SLOW_S for r in launch)
    assert all(r.measured_s >= _SLOW_S for r in compile_)  # svc, as before
    # the telemetry keeps both sleeps: staging, and the service time
    # (launch to readback)
    assert m["phases"]["stack"]["mean_ms"] * 1e-3 >= _SLOW_S
    assert m["service_ewma_ms"] * 1e-3 >= _SLOW_S


def _launch_rows(scale_s_per_frame=None):
    """The golden fixture's trial rows (device times on the card) as the
    ``launch`` rows of batches of 1, 2, 4 and 8 frames: the features
    gain ``items``, and the measured time is the frames times the
    single-frame device time, or ``scale_s_per_frame`` a frame (what a
    row timing the whole host service would hold)."""
    rows = []
    with open(_FIXTURE) as f:
        trials = [json.loads(line) for line in f]
    for d in trials:
        for items in (1, 2, 4, 8):
            feats = dict(d["attrs"]["features"], items=items)
            per_frame = (d["measured_s"] if scale_s_per_frame is None
                         else scale_s_per_frame)
            rows.append(DriftRow(
                kind="launch", signature=d["signature"],
                shapes=d["shapes"], backend=d["backend"],
                modeled_s=d["modeled_s"] * items,
                measured_s=per_frame * items,
                attrs={"features": feats, "width": items}))
    return rows


def test_calibrate_on_device_timed_launch_rows_is_physical():
    """Fitted on launch rows alone: device times give a bandwidth the
    card has (the card's trial fit is 1.32e12-1.38e12 B/s, its data
    sheet 3.35e12), where service times (8 ms a frame) gave 2e9."""
    fit = calibrate(_launch_rows(), spec=H100)
    assert fit.fitted
    assert 0.1 * H100.hbm_bw <= fit.spec.hbm_bw <= 1.05 * H100.hbm_bw
    stale = calibrate(_launch_rows(scale_s_per_frame=8e-3), spec=H100)
    assert stale.spec.hbm_bw < 1e-2 * H100.hbm_bw


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_replicated_on_card_repeated_device_bit_exact():
    _needs_card()
    rng = np.random.default_rng(2)
    for name in ("filter_chain", "optical_flow_lk"):
        app = compile_graph(tapps.build_app(name, 240, 512))
        x = {c.name: torch.from_numpy(
                 rng.standard_normal(c.shape).astype(np.float32)).cuda()
             for c in app.graph.graph_inputs}
        want = app(**x)
        rep = replicate_app(app, 2, devices=["cuda:0", "cuda:0"])
        before = stream_group.launches
        got = rep(**x)
        torch.cuda.synchronize()
        assert (stream_group.launches - before
                == 2 * len(rep.schedule.groups))
        for n in want:
            assert torch.equal(got[n], want[n]), name


@pytest.mark.gpu
def test_engine_replicas_need_the_cards():
    _needs_card()
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices are visible"):
        StreamEngine(replicas=n + 1, autostart=False)


@pytest.mark.gpu
def test_served_launch_row_times_the_device(tmp_path):
    """A served batch's ``launch`` row lies within 2x of the same
    width's device-resident batched launch timed alone by ``CardTimer``
    (a spin kernel queued first, the L2 flushed, best of 10), which
    shares no code with the rows' launch gate."""
    _needs_card()
    g = tapps.build_app("unsharp_mask", 512, 1024)
    rng = np.random.default_rng(4)
    frames = [rng.standard_normal((512, 1024)).astype(np.float32)
              for _ in range(8)]
    path = str(tmp_path / "drift.jsonl")
    with StreamEngine(max_batch=8, drift=path, bucket_pad=False) as eng:
        for _ in range(4):
            hs = [eng.submit(g, {"img": f}) for f in frames]
            for h in hs:
                h.result(timeout=T)
        app = eng.cache.get(g, backend="cuda_stream", device=eng.device)
    rows = [r for r in DriftLog(path).rows()
            if r.kind == "launch" and r.attrs.get("width") == 8]
    assert len(rows) == 3
    xs = torch.from_numpy(np.stack(frames)).cuda()
    alone = search.CardTimer()(lambda: app.batch_fn(xs), reps=10)
    for r in rows:
        assert 0.5 * alone <= r.measured_s <= 2.0 * alone, (
            r.measured_s, alone)


@pytest.mark.gpu
def test_launch_gate_holds_the_stream_until_released():
    """Behind a gate, a pair of events around a kernel queued 5 ms
    after the gate reads the kernel, not the 5 ms; an event before the
    gate reads the wait.  The kernel runs once first: under CUDA's lazy
    loading, a kernel's first launch waits for the card's running
    kernels, the gate among them, which then times out."""
    _needs_card()
    gate = LaunchGate("cuda")
    x = torch.ones(1 << 20, device="cuda")
    assert torch.equal(x * 2.0, torch.full_like(x, 2.0))
    torch.cuda.synchronize()
    before = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before.record()
    ticket = gate.hold()
    start.record()
    time.sleep(5e-3)
    y = x * 2.0
    end.record()
    gate.release(ticket)
    end.synchronize()
    assert not gate.late(ticket)
    assert before.elapsed_time(end) >= 5.0                 # ms
    assert start.elapsed_time(end) < 1.0
    assert torch.equal(y, x * 2.0)


@pytest.mark.gpu
def test_launch_gate_lets_go_after_its_timeout():
    """A gate never released lets its stream go after its timeout and
    marks its ticket late; a later gate released in time is not."""
    _needs_card()
    gate = LaunchGate("cuda")
    ticket = gate.hold()
    torch.cuda.synchronize()                # would hang without the timeout
    assert gate.late(ticket)
    gate.release(ticket)
    nxt = gate.hold()
    gate.release(nxt)
    torch.cuda.synchronize()
    assert gate.late(ticket) and not gate.late(nxt)
