"""The port's meshes, sharding rules, ring collectives and pipeline
against the JAX package's, on the CPU.

- ``spec_for_axes`` / ``param_axes`` / ``train_state_shardings`` /
  ``cache_shardings`` decide as the reference does, leaf by leaf, notes
  included (exact).  The reference's rules read only ``mesh.shape``, so
  ``jax.sharding.AbstractMesh`` drives them in this process, even at
  16 x 16, with no devices forced.
- ``ring_allgather_matmul``, ``ring_matmul_reducescatter``,
  ``psum_scatter_grads`` and ``pipeline_apply`` against the reference run
  on 8 forced host devices in a subprocess (as
  ``tests/test_distribution.py`` runs them), on the inputs of its
  ``test_ring_collectives_match_barrier`` and
  ``test_pipeline_parallel_matches_sequential``: within 1e-5 x max|ref|
  (float32 products; the ring's blocks are summed in another order than
  XLA's), the pipeline's step law counted.
- Elastic restore: saved on 2 x 4, restored on 4 x 2 and on one device,
  leaves exactly equal; a checkpoint the reference saved sharded on
  2 x 4 restores onto the port's 4 x 2 mesh bit for bit.

A mesh here is ``devices=["cpu"] * k``: one device named k times, one
process driving every position (a deliberate difference: the
reference's meshes hold distinct devices).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import checkpointer as TC  # noqa: E402
from repro_torch.device import DeviceUnavailableError  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ShapeConfig as TShape  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import collectives as TCol  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    from jax.sharding import AbstractMesh
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.models.config import ShapeConfig as JShape
    from repro.parallel import sharding as JS
    from repro.runtime import steps as jsteps
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parent.parent
MESH_SHAPES = ((2, 4), (4, 2), (1, 8), (16, 16))
FAMILY_ARCHS = ("granite_3_2b", "granite_moe_3b_a800m", "minicpm3_4b",
                "mamba2_2p7b", "zamba2_1p2b", "whisper_base",
                "internvl2_26b")


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _cpu_mesh(shape, names=("data", "model")):
    return TS.make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _spec(s) -> tuple:
    return tuple(tuple(d) if isinstance(d, (list, tuple)) else d for d in s)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    return out


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def test_mesh_shape_devices_and_refusals():
    m = tmesh.make_local_mesh(2, 4, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert list(m.shape) == ["data", "model"] and m.single_device
    assert m.devices[1, 3] == torch.device("cpu")
    # more distinct devices than exist: ValueError, as jax.make_mesh
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_local_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    p = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="one type"):
        TS.Mesh(np.array([torch.device("cpu"), torch.device("meta")]),
                ("data",))
    # the launchers' mesh: one device takes every position
    assert tmesh.launch_mesh(2, 2, "cpu").shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():   # no silent CPU mesh for a card
        with pytest.raises(DeviceUnavailableError):
            tmesh.make_local_mesh(2, 2, devices=["cuda"] * 4)
        with pytest.raises(DeviceUnavailableError):
            tmesh.launch_mesh(2, 2)
    # the replica mesh is as it was
    r = TS.replica_mesh(3, axis="data", device="cpu")
    assert r.shape == {"data": 3} and len(r.devices) == 3


def test_named_sharding_pieces_are_contiguous_copies():
    """shard: one contiguous copy a position, never a view of the input
    (so a neighbour copy on one device is a real copy); gather puts it
    back bit for bit; replicated positions hold equal copies."""
    m = _cpu_mesh((2, 4))
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    for spec in (TS.P("data", "model"), TS.P(None, "model"),
                 TS.P(("data", "model")), TS.P(), TS.P("model", None, None)):
        st = TS.NamedSharding(m, spec).shard(x)
        assert torch.equal(st.gather(), x), spec
        ptrs = {t.data_ptr() for t in st.pieces()}
        assert len(ptrs) == 8, spec            # eight separate copies
        assert all(t.is_contiguous() for t in st.pieces())
        assert x.data_ptr() not in ptrs
        n_distinct = len(st.leader_pieces())
        assert n_distinct == int(np.prod(
            st.sharding.pieces_per_dim(3))), spec
    st = TS.NamedSharding(m, TS.P(("data", "model"))).shard(x)
    assert torch.equal(st.shards[1, 2], x[6:7])   # the data axis outermost
    with pytest.raises(ValueError, match="uneven"):
        TS.NamedSharding(m, TS.P(None, None, "model")).shard(x)
    with pytest.raises(ValueError, match="twice"):
        TS.NamedSharding(m, TS.P("data", "data"))
    # rows of a sharded tensor, read and written in place
    st = TS.NamedSharding(m, TS.P("data", "model")).shard(x)
    out = torch.empty(3, 12, 3)
    assert torch.equal(st.gather_rows(0, 2, 5, out), x[2:5])
    st.scatter_rows(0, 2, -out)
    assert torch.equal(st.gather()[2:5], -x[2:5])
    assert torch.equal(st.gather()[5:], x[5:])


def test_resident_bytes_are_the_specs_share():
    """The model axis splits memory: each position holds exactly its
    spec's share of the train state (the pinned deliberate difference:
    memory, not arithmetic)."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    m = _cpu_mesh((2, 4))
    sh = tsteps.train_state_shardings(cfg, m)
    state = tsteps.shard_train_state(TM.init(cfg, 0, device="cpu"), sh)
    want = TS.resident_bytes(sh, tsteps.abstract_train_state(cfg))
    got = np.zeros((2, 4), np.int64)
    for leaf in tree_leaves(state):
        for pos in m.positions():
            got[pos] += leaf.nbytes_at(pos)
    assert np.array_equal(got, want)
    full = sum(t.numel() * t.element_size() for t in tree_leaves(
        TS.gather_tree(state)))
    # the fully split leaves hold 1/8 a position; replicated ones more
    assert full / 8 <= got.max() < full / 2, (got, full)
    per = tmesh.bytes_per_device(m, sh, tsteps.abstract_train_state(cfg))
    assert per == {torch.device("cpu"): int(want.sum())}


# ----------------------------------------------------------------------
# rules and specs against the reference
# ----------------------------------------------------------------------
def test_rules_equal_the_reference():
    _needs_jax()
    for t, j in ((TS.TRAIN_RULES, JS.TRAIN_RULES),
                 (TS.SERVE_RULES, JS.SERVE_RULES)):
        assert t.rules == j.rules and t.uneven_ok == j.uneven_ok
    r = TS.TRAIN_RULES.replace(seq_model="model", embed=None)
    assert r.rules == JS.TRAIN_RULES.replace(seq_model="model",
                                             embed=None).rules
    assert r.binding("seq_model") == "model" and r.binding(None) is None
    for shape in MESH_SHAPES:
        am = AbstractMesh(shape, ("data", "model"))
        for b in (None, "model", ("pod", "data"), ("data", "model")):
            assert TS.mesh_axis_size(am, b) == JS.mesh_axis_size(am, b)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_specs_match_the_reference(arch):
    """param_axes equal; every leaf's spec and the notes list equal under
    TRAIN_RULES and SERVE_RULES on 2x4, 4x2, 1x8 and 16x16; activation
    specs (allow_uneven) on the attention heads equal too."""
    _needs_jax()
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    axes = TM.param_axes(tcfg)
    assert axes == JM.param_axes(cfg)
    defs = _flat(TM.param_defs(tcfg))
    flat_axes = _flat(axes)
    n = 0
    for shape in MESH_SHAPES:
        am = AbstractMesh(shape, ("data", "model"))
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            tn, jn = [], []
            for k, ax in flat_axes.items():
                shp = defs[k].shape
                got = TS.spec_for_axes(am, getattr(TS, rules), ax, shp, tn)
                want = JS.spec_for_axes(am, getattr(JS, rules), ax, shp, jn)
                assert _spec(got) == _spec(want), (shape, rules, k)
                n += 1
            assert tn == jn, (shape, rules)
            act = ("batch", "seq", "heads", None)
            ashp = (64, 128, cfg.n_heads, cfg.hd)
            assert _spec(TS.spec_for_axes(am, getattr(TS, rules), act, ashp,
                                          allow_uneven=True)) == \
                _spec(JS.spec_for_axes(am, getattr(JS, rules), act, ashp,
                                       allow_uneven=True))
    print(f"{arch}: {n} leaf specs equal")


@pytest.mark.parametrize("arch", ("granite_3_2b", "qwen15_32b",
                                  "zamba2_1p2b"))
def test_train_state_shardings_match_the_reference(arch):
    _needs_jax()
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in ((2, 4), (16, 16)):
        am = AbstractMesh(shape, ("data", "model"))
        tn, jn = [], []
        got = tsteps.train_state_shardings(tcfg, _FakeMesh(am),
                                           compress_grads=True, notes=tn)
        want = jsteps.train_state_shardings(cfg, am, compress_grads=True,
                                            notes=jn)
        want = jax.tree.map(lambda s: s.spec, want)
        got_flat = {k: _spec(v.spec) for k, v in _flat(got).items()}
        want_flat = {k: _spec(v) for k, v in _flat(_as_dict(want)).items()}
        assert got_flat == want_flat and tn == jn, shape


class _FakeMesh:
    """A mesh by its ``shape`` alone (the port's NamedSharding checks
    only the axis names), for meshes larger than this host."""

    def __init__(self, am):
        self.shape = dict(am.shape)
        self.axis_names = tuple(self.shape)


def _as_dict(tree):
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_shardings_match_the_reference(arch):
    """One config of each family at full size: every cache leaf's spec
    (minicpm3's c_kv / k_rope over seq_model, whisper's enc_out, mamba2's
    conv / ssm over ssm_inner, k / v over kv_heads or seq_model, index
    replicated) and the batch's specs, on 2x4, 4x2 and 16x16."""
    _needs_jax()
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in ((2, 4), (4, 2), (16, 16)):
        am = AbstractMesh(shape, ("data", "model"))
        js = JShape("decode_2k", 2048, 32, "decode")
        ts = TShape("decode_2k", 2048, 32, "decode")
        got = _flat(tsteps.cache_shardings(tcfg, ts, _FakeMesh(am)))
        want = jax.tree_util.tree_flatten_with_path(
            jsteps.cache_shardings(cfg, js, am))[0]
        want = {".".join(str(getattr(p, "key", p)) for p in path): _spec(
            s.spec) for path, s in want}
        assert {k: _spec(v.spec) for k, v in got.items()} == want, shape
        for kind in ("train", "prefill", "decode"):
            bt = tsteps.batch_shardings(tcfg, TShape("b", 4096, 64, kind),
                                        _FakeMesh(am), TS.TRAIN_RULES)
            bj = jsteps.batch_shardings(cfg, JShape("b", 4096, 64, kind), am,
                                        JS.TRAIN_RULES)
            assert {k: _spec(v.spec) for k, v in bt.items()} == \
                {k: _spec(v.spec) for k, v in bj.items()}
            tb = tsteps.batch_specs(tcfg, TShape("b", 4096, 64, kind))
            jb = jsteps.batch_specs(cfg, JShape("b", 4096, 64, kind))
            assert {k: tuple(v.shape) for k, v in tb.items()} == \
                {k: tuple(v.shape) for k, v in jb.items()}


def _activation_points(cfg, B=64, S=128):
    """(logical axes, shape) of the activations the reference constrains
    (``src/repro/models/layers.py``'s ``shard_act`` calls): embed, the
    logits, q, k, v, the attention output, the MLP output, and MoE's
    dispatch / combine buffers."""
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    pts = [(("batch", "seq", None), (B, S, d)),
           (("batch", "seq", "vocab"), (B, S, cfg.vocab_size)),
           (("batch", "seq", "heads", None), (B, S, hq, cfg.hd)),
           (("batch", "kv_heads", "seq", None), (B, hkv, S, cfg.hd)),
           (("batch", "seq", "heads"), (B, S, hq * cfg.hd))]
    if cfg.n_experts:
        pts.append((("batch", "experts", None, None),
                    (B, cfg.n_experts, 16, d)))
    return pts


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_activation_specs_match_the_reference(arch):
    """The spec the reference constrains each activation to
    (``spec_for_axes(..., allow_uneven=True)``) is the port's too, for
    both rule sets on every mesh shape: what tensor parallelism will
    place (the port itself keeps activations whole, ROADMAP C)."""
    _needs_jax()
    cfg = tconfigs.get_config(arch)
    n = 0
    for shape in MESH_SHAPES:
        am = AbstractMesh(shape, ("data", "model"))
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            for axes, shp in _activation_points(cfg):
                got = TS.spec_for_axes(am, getattr(TS, rules), axes, shp,
                                       allow_uneven=True)
                want = JS.spec_for_axes(am, getattr(JS, rules), axes, shp,
                                        allow_uneven=True)
                assert _spec(got) == _spec(want), (shape, rules, axes, shp)
                n += 1
    print(f"{arch}: {n} activation specs equal")


# ----------------------------------------------------------------------
# ring collectives and the pipeline, against the reference
# ----------------------------------------------------------------------
_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel._compat import shard_map
from repro.parallel.collectives import (ring_allgather_matmul,
                                        ring_matmul_reducescatter,
                                        psum_scatter_grads)
from repro.parallel.pipeline import pipeline_apply
out = {{}}
mesh = jax.make_mesh((8,), ("model",))
rng = np.random.default_rng(0)
x = jnp.asarray(rng.normal(size=(64, 128)), jnp.float32)
w = jnp.asarray(rng.normal(size=(128, 96)), jnp.float32)
out["ag"] = np.asarray(ring_allgather_matmul(x, w, mesh))
out["rs"] = np.asarray(ring_matmul_reducescatter(x, w, mesh))
g = jnp.asarray(rng.normal(size=(8, 16, 3)), jnp.float32)
fn = shard_map(lambda gs: psum_scatter_grads(gs[0], axis="model"),
               mesh=mesh, in_specs=(P("model"),), out_specs=P("model"),
               check_vma=False)
out["g"] = np.asarray(g)
out["psum_scatter"] = np.asarray(fn(g))
pmesh = jax.make_mesh((8,), ("stage",))
rng = np.random.default_rng(0)
ws = jnp.asarray(rng.normal(size=(8, 32, 32)) * 0.3, jnp.float32)
xb = jnp.asarray(rng.normal(size=(16, 32)), jnp.float32)
out["pipe"] = np.asarray(pipeline_apply(lambda p, x: jnp.tanh(x @ p), ws, xb,
                                        pmesh, n_micro=4, axis="stage"))
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's ring products, reduce-scatter and pipeline on 8
    forced host devices, in a subprocess."""
    _needs_jax()
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", _REF.format(
        src=str(ROOT / "src"), path=str(path))], capture_output=True,
        text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


def _ring_inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 96)).astype(np.float32))
    return x, w


@pytest.mark.parametrize("which", ["allgather", "reducescatter"])
def test_ring_products_match_the_reference(which, reference_run):
    x, w = _ring_inputs()
    mesh = _cpu_mesh((8,), ("model",))
    if which == "allgather":
        got, want = TCol.ring_allgather_matmul(x, w, mesh), reference_run["ag"]
    else:
        got = TCol.ring_matmul_reducescatter(x, w, mesh)
        want = reference_run["rs"]
    err = float(np.abs(got.numpy() - want).max())
    barrier = float((x @ w - got).abs().max())
    print(f"ring {which}: max abs err {err:.3e} vs the reference, "
          f"{barrier:.3e} vs x @ w")
    assert err <= 1e-5 * np.abs(want).max()
    assert barrier <= 1e-5 * float((x @ w).abs().max())


def test_ring_order_and_copies():
    """The ring's hops are real copies into new tensors (P - 1 hops of
    P blocks for the all-gather; the reduce-scatter's sum is the
    partials' in the reference's (idx - 1 - i) order)."""
    x, w = _ring_inputs()
    mesh = _cpu_mesh((4,), ("model",))
    blocks = [torch.full((2, 3), float(j)) for j in range(4)]
    moved = TCol.ppermute(blocks, list(mesh.devices))
    assert [float(b[0, 0]) for b in moved] == [3.0, 0.0, 1.0, 2.0]
    assert not {b.data_ptr() for b in moved} & {b.data_ptr() for b in blocks}
    xs = TS.NamedSharding(mesh, TS.P("model", None)).shard(x).pieces()
    ws = TS.NamedSharding(mesh, TS.P(None, "model")).shard(w).pieces()
    outs = TCol.ring_allgather_shards(xs, ws)
    assert [tuple(o.shape) for o in outs] == [(64, 24)] * 4
    for j, o in enumerate(outs):           # column block j, bit for bit
        assert torch.equal(o, torch.cat([xb @ ws[j] for xb in xs]))
    xs = TS.NamedSharding(mesh, TS.P(None, "model")).shard(x).pieces()
    ws = TS.NamedSharding(mesh, TS.P("model", None)).shard(w).pieces()
    outs = TCol.ring_reducescatter_shards(xs, ws)
    parts = [a @ b for a, b in zip(xs, ws)]
    for j, o in enumerate(outs):
        # block j ends at shard j after starting at j + 1: it adds the
        # partials of shards j+1, j+2, ..., j in that order
        order = [(j + 1 + i) % 4 for i in range(4)]
        want = parts[order[0]][16 * j:16 * (j + 1)].clone()
        for k in order[1:]:
            want += parts[k][16 * j:16 * (j + 1)]
        assert torch.equal(o, want), j


def test_psum_scatter_grads_matches_the_reference(reference_run):
    g = reference_run["g"]
    mesh = _cpu_mesh((8,), ("model",))
    trees = [{"w": torch.from_numpy(g[j]), "b": {"c": torch.from_numpy(
        g[j, :8, 0].copy())}} for j in range(8)]
    got = TCol.psum_scatter_grads(trees, mesh, axis="model")
    assert len(got) == 8 and set(got[0]) == {"w", "b"}
    w = torch.cat([t["w"] for t in got]).numpy()
    want = reference_run["psum_scatter"]
    err = float(np.abs(w - want).max())
    print(f"psum_scatter_grads: max abs err {err:.3e}")
    assert err <= 1e-5 * np.abs(want).max()
    c = torch.cat([t["b"]["c"] for t in got]).numpy()
    assert np.allclose(c, g[:, :8, 0].sum(0), rtol=1e-6, atol=1e-6)


def test_pipeline_matches_the_reference_and_its_step_law(reference_run):
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.normal(size=(8, 32, 32)) * 0.3)
                          .astype(np.float32))
    xb = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    calls: dict = {}

    def stage(p, x):
        calls[p.data_ptr()] = calls.get(p.data_ptr(), 0) + 1
        return torch.tanh(x @ p)

    mesh = _cpu_mesh((8,), ("stage",))
    got = pipeline_apply(stage, ws, xb, mesh, n_micro=4, axis="stage")
    want = reference_run["pipe"]
    err = float(np.abs(got.numpy() - want).max())
    seq = xb
    for i in range(8):
        seq = torch.tanh(seq @ ws[i])
    print(f"pipeline: max abs err {err:.3e} vs the reference, "
          f"{float((got - seq).abs().max()):.3e} vs sequential")
    assert err <= 1e-5 * np.abs(want).max()
    assert torch.allclose(got, seq, atol=1e-6)
    # every stage ran at every step: n_micro + n_stages - 1 = 11 each
    assert len(calls) == 8 and set(calls.values()) == {11}


@pytest.mark.parametrize("n_stages,n_micro", [(2, 1), (3, 6), (4, 2)])
def test_pipeline_step_law(n_stages, n_micro):
    torch.manual_seed(0)
    ws = torch.randn(n_stages, 8, 8) * 0.3
    x = torch.randn(6 * n_micro, 8)
    steps: list = []

    def stage(p, h):
        steps.append(p.data_ptr())
        return torch.tanh(h @ p)

    mesh = _cpu_mesh((n_stages,), ("stage",))
    got = pipeline_apply(stage, ws, x, mesh, n_micro)
    seq = x
    for i in range(n_stages):
        seq = torch.tanh(seq @ ws[i])
    assert torch.allclose(got, seq, atol=1e-6)
    assert len(steps) == n_stages * (n_micro + n_stages - 1)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(stage, ws, x[:-1], mesh, max(n_micro, 2))


def test_pipeline_takes_a_tree_of_stage_params():
    torch.manual_seed(1)
    tree = {"a": torch.randn(3, 4, 4) * 0.3, "b": {"c": torch.randn(3, 4)}}
    x = torch.randn(6, 4)
    mesh = _cpu_mesh((3,), ("stage",))
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p["a"] + p["b"]["c"]),
                         tree, x, mesh, n_micro=3)
    seq = x
    for i in range(3):
        seq = torch.tanh(seq @ tree["a"][i] + tree["b"]["c"][i])
    assert torch.allclose(got, seq, atol=1e-6)
    with pytest.raises(ValueError, match="other axes"):
        pipeline_apply(lambda p, h: h, tree, x,
                       _cpu_mesh((3, 2), ("stage", "data")), 3)


# ----------------------------------------------------------------------
# elastic restore
# ----------------------------------------------------------------------
def test_elastic_restore_across_mesh_shapes(tmp_path):
    """Saved on 2 x 4, restored on 4 x 2 and on one device: every leaf
    equal bit for bit, and in its own type (the master float32, the
    step int32)."""
    cfg = dataclasses.replace(tconfigs.get_smoke("granite_3_2b"),
                              dtype="bfloat16")
    m1, m2 = _cpu_mesh((2, 4)), _cpu_mesh((4, 2))
    sh1 = tsteps.train_state_shardings(cfg, m1, compress_grads=True)
    state = tsteps.shard_train_state(TM.init(cfg, 1, device="cpu"), sh1,
                                     compress_grads=True)
    for t in tree_leaves(state["opt"]["m"]):
        for p in t.pieces():
            p.normal_(generator=torch.Generator().manual_seed(2))
    TC.save_pytree(state, str(tmp_path), 3)
    like = tsteps.abstract_train_state(cfg, compress_grads=True)
    sh2 = tsteps.train_state_shardings(cfg, m2, compress_grads=True)
    on2 = TC.restore_pytree(like, str(tmp_path), 3, shardings=sh2)
    on1 = TC.Checkpointer(str(tmp_path)).restore(like, 3, device="cpu")
    want = tree_leaves(TS.gather_tree(state))
    got2 = [t.gather() for t in tree_leaves(on2)]
    for a, b, c in zip(want, got2, tree_leaves(on1)):
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a, b) and torch.equal(a, c)
    leaf = on2["params"]["blocks"]["attn"]["wq"]
    assert leaf.sharding.mesh is m2 and _spec(leaf.sharding.spec) == (
        None, "data", "model")
    assert int(on2["opt"]["step"]) == 0


_REF_SAVE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax
from repro.configs import get_smoke
from repro.models import model as M
from repro.optim.adamw import adamw_init
from repro.runtime import steps as S
from repro.checkpoint.checkpointer import save_pytree
cfg = get_smoke("granite_3_2b")
params = M.init(cfg, jax.random.PRNGKey(1))
state = {{"params": params, "opt": adamw_init(params)}}
mesh = jax.make_mesh((2, 4), ("data", "model"))
state = jax.device_put(state, S.train_state_shardings(cfg, mesh))
save_pytree(state, {path!r}, 3)
"""


def test_restore_a_checkpoint_the_reference_saved_sharded(tmp_path):
    _needs_jax()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", _REF_SAVE.format(
        src=str(ROOT / "src"), path=str(tmp_path))], capture_output=True,
        text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    cfg = tconfigs.get_smoke("granite_3_2b")
    m = _cpu_mesh((4, 2))
    got = TC.restore_pytree(tsteps.abstract_train_state(cfg), str(tmp_path),
                            3, shardings=tsteps.train_state_shardings(cfg, m))
    jp = JM.init(jconfigs.get_smoke("granite_3_2b"), jax.random.PRNGKey(1))
    want = _flat(jax.tree.map(np.asarray, jp))
    flat = _flat(got["params"])
    assert set(flat) == set(want)
    for k, w in want.items():
        assert np.array_equal(flat[k].gather().numpy(), w), k
    master = _flat(got["opt"]["master"])
    assert all(np.array_equal(master[k].gather().numpy(),
                              want[k].astype(np.float32)) for k in want)
