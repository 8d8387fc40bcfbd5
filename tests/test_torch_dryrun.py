"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, and the
two example twins.

Against the JAX package: ``skip_reason``, ``runtime_cfg``, ``arch_rules``
and ``calib_layers`` for every arch x shape, exactly.  Then one cell,
granite-3-2b's smoke config training 16 x 32 tokens on a 2 x 2 mesh of
``meta`` devices: nothing is allocated; its product FLOPs equal the
count written out below within 0.5 %; its argument bytes equal the
sharding plan's busiest position; its collective bytes equal the
parameters gathered plus the gradients scattered, counted here from the
shardings; its row has the reference's ``RooflineReport`` fields; the
calibrated total equals the full count.  ``main`` writes a row; the
collective counter counts nothing outside a dry run.  The example twins
run with ``--device cpu``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (bytes_per_device,  # noqa: E402
                                     make_local_mesh)
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import traffic  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

try:                                 # the card's machine has no JAX
    import jax  # noqa: F401
    from repro import configs as jconfigs
    from repro.analysis.roofline import RooflineReport
    from repro.parallel import sharding as JS
except ImportError:
    jconfigs = None


def _needs_jax():
    if jconfigs is None:
        pytest.skip("needs JAX and the repro package")


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported with the environment restored:
    importing it sets ``XLA_FLAGS`` for 512 host devices."""
    _needs_jax()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


class _Shape:
    """A mesh stand-in: ``arch_rules`` reads only ``shape``."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("overrides", [None, {"ep_over_data": True},
                                       {"microbatches": 2}])
def test_cell_rules_match_the_reference(jdry, overrides):
    for arch in tconfigs.ARCHS:
        tcfg0, jcfg0 = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for name, tshape in tconfigs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            assert D.skip_reason(tcfg0, tshape) == \
                jdry.skip_reason(jcfg0, jshape)
            tcfg = D.runtime_cfg(tcfg0, tshape, dict(overrides or {}))
            jcfg = jdry.runtime_cfg(jcfg0, jshape, dict(overrides or {}))
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert D.EP_OVER_DATA == jdry.EP_OVER_DATA
            assert D.calib_layers(tcfg) == jdry.calib_layers(jcfg)
            for mesh in (_Shape(data=16, model=16),
                         _Shape(pod=2, data=16, model=16),
                         _Shape(data=8, model=5)):
                for t_rules, j_rules in ((TS.TRAIN_RULES, JS.TRAIN_RULES),
                                         (TS.SERVE_RULES, JS.SERVE_RULES)):
                    got = D.arch_rules(tcfg, mesh, t_rules)
                    want = jdry.arch_rules(jcfg, mesh, j_rules)
                    assert got.rules == want.rules, (arch, name)
                    assert got.uneven_ok == want.uneven_ok


# ----------------------------------------------------------------------
# one cell on a 2 x 2 meta mesh
# ----------------------------------------------------------------------
ARCH = "granite_3_2b"
SHAPE = ShapeConfig("small_train", 32, 16, "train")
OVERRIDES = {"microbatches": 2}


@pytest.fixture(scope="module")
def cell():
    cfg = tconfigs.get_smoke(ARCH)
    mesh = make_local_mesh(2, 2, devices=["meta"] * 4)
    row = D.run_cell(ARCH, SHAPE.name, overrides=OVERRIDES, cfg=cfg,
                     shape=SHAPE, mesh=mesh, mesh_name="2x2")
    return cfg, mesh, row


def test_cell_flops_are_the_products_written_out(cell):
    """Per layer: the q, k, v and o projections, the MLP's three
    products and the attention's two (the plain oracle multiplies every
    query by every key), then the tied head; a training step is the
    forward and two backward products each, and remat "dots" recomputes
    the attention products (it saves ``aten.mm`` outputs only)."""
    cfg, _, row = cell
    d, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff, V, L = cfg.d_ff, cfg.vocab_size, cfg.n_layers
    B, S = SHAPE.global_batch, SHAPE.seq_len
    T = B * S
    proj = (2 * T * d * (Hq + 2 * Hkv) * hd + 2 * T * Hq * hd * d
            + 3 * 2 * T * d * ff)
    attn = 2 * (2 * B * Hq * S * S * hd)
    head = 2 * T * d * V
    want = 3 * (L * proj + head) + 4 * L * attn
    assert row["status"] == "ok"
    assert abs(row["hlo_flops"] - want) <= 5e-3 * want, (row["hlo_flops"],
                                                          want)


def test_cell_arguments_are_the_sharding_plan(cell):
    cfg, mesh, row = cell
    run_cfg = dataclasses.replace(D.runtime_cfg(cfg, SHAPE, OVERRIDES),
                                  attn_impl="ref")
    state_sh = tsteps.train_state_shardings(run_cfg, mesh)
    state_av = tsteps.abstract_train_state(run_cfg)
    batch_sh = tsteps.batch_shardings(run_cfg, SHAPE, mesh, TS.TRAIN_RULES)
    batch_av = tsteps.batch_specs(run_cfg, SHAPE)
    per_pos = (TS.resident_bytes(state_sh, state_av)
               + TS.resident_bytes(batch_sh, batch_av))
    mem = row["bytes_per_chip"]
    assert mem["argument_size_in_bytes"] == int(per_pos.max())
    # a meta mesh is one device: bytes_per_device sums its positions
    total = bytes_per_device(mesh, state_sh, state_av)
    assert sum(total.values()) == int(
        TS.resident_bytes(state_sh, state_av).sum())
    assert mem["alias_size_in_bytes"] == int(
        TS.resident_bytes(state_sh, state_av).max())
    assert 0 < mem["temp_size_in_bytes"] <= row["temp_peak_all_shards"]
    assert all(t.device.type == "meta" for t in tree_leaves(state_av))


def test_cell_collectives_are_the_gathers_and_the_scatters(cell):
    """Each of the 2 data shards (at positions (0, 0) and (1, 0)) gathers
    every parameter but the piece it holds; each parameter's gradient is
    reduce-scattered once a step: the second shard's part moved to the
    first, then each other position's float32 piece."""
    cfg, mesh, row = cell
    run_cfg = dataclasses.replace(D.runtime_cfg(cfg, SHAPE, OVERRIDES),
                                  attn_impl="ref")
    shardings = tree_leaves(tsteps.train_state_shardings(run_cfg, mesh)
                            ["params"])
    params = tree_leaves(tsteps.abstract_train_state(run_cfg)["params"])
    D_shards = 2
    gathered = scattered = 0
    for sh, p in zip(shardings, params):
        whole = p.numel() * p.element_size()
        pieces = math.prod(sh.pieces_per_dim(p.dim()))
        gathered += D_shards * (whole - whole // pieces)
        scattered += ((D_shards - 1) * whole
                      + (mesh.size - 1) * 4 * p.numel() // pieces)
    got = row["coll_breakdown"]
    assert got["all-gather"] == gathered
    assert got["reduce-scatter"] == scattered
    assert got["all-reduce"] == got["all-to-all"] == \
        got["collective-permute"] == 0
    assert row["coll_bytes"] == gathered + scattered


def test_cell_row_has_the_reference_fields_and_calibrates(cell):
    _needs_jax()
    _, _, row = cell
    fields = {f.name for f in dataclasses.fields(RooflineReport)}
    assert fields <= set(row)
    assert row["chips"] == row["n_chips"] == 4 and row["mesh"] == "2x2"
    assert row["dominant"] in ("compute", "memory", "collective")
    cal = row["calibration"]
    assert cal["matches"] == {"flops": True, "bytes": True, "coll": True}
    for k in ("flops", "bytes", "coll"):
        assert abs(cal["total"][k] - row["raw"][k]) <= 1e-6 * row["raw"][k]
    assert "attn_impl='ref'" in row["note"]
    json.dumps(row)


def test_main_writes_a_row_and_skips_long_context(tmp_path, monkeypatch):
    """``main`` at smoke width on a 2 x 2 meta mesh (the production
    configs and mesh swapped for them): one decode cell written as JSON;
    long_500k on a pure-attention config is a skip row."""
    monkeypatch.setattr(D, "get_config", tconfigs.get_smoke)
    monkeypatch.setattr(D, "meta_mesh", lambda multi_pod: make_local_mesh(
        2, 2, devices=["meta"] * 4))
    out = tmp_path / "row.json"
    D.main(["--arch", ARCH, "--shape", "decode_32k", "--out", str(out)])
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["shape"] == "decode_32k"
    assert row["raw"]["coll_breakdown"]["all-gather"] > 0
    assert row["raw"]["coll_breakdown"]["collective-permute"] > 0
    D.main(["--arch", ARCH, "--shape", "long_500k", "--out", str(out)])
    assert json.loads(out.read_text())["status"] == "skip"
    assert D.cell_path("a", "b", "pod") == os.path.join(
        "experiments", "dryrun_torch", "a__b__pod.json")


def test_sweep_runs_one_subprocess_a_cell(tmp_path, monkeypatch):
    """One ``python -m repro_torch.launch.dryrun`` a missing cell; the
    slow cell only when its arch is named."""
    monkeypatch.chdir(tmp_path)
    launched = []

    class Proc:
        def __init__(self, cmd, **kw):
            launched.append(cmd)
            assert str(ROOT / "src") in kw["env"]["PYTHONPATH"]

        def poll(self):
            return 0

    monkeypatch.setattr(D.subprocess, "Popen", Proc)
    monkeypatch.setattr(D.time, "sleep", lambda s: None)
    D.sweep("pod", 4)
    cells = {(c[c.index("--arch") + 1], c[c.index("--shape") + 1])
             for c in launched}
    assert len(launched) == len(cells) == \
        len(tconfigs.ARCHS) * len(tconfigs.SHAPES) - len(D.SLOW_CELLS)
    assert not cells & D.SLOW_CELLS
    assert all(c[1:3] == ["-m", "repro_torch.launch.dryrun"]
               for c in launched)
    launched.clear()
    D.sweep("both", 2, archs=["qwen3_moe_235b_a22b"])
    assert len(launched) == 2 * len(tconfigs.SHAPES)


def test_the_counter_counts_nothing_outside_a_dry_run():
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    x = TS.NamedSharding(mesh, TS.P("model")).shard(torch.ones(8, 4))
    assert not traffic.active()
    x.gather()
    with traffic.count_traffic() as counts:
        assert traffic.active()
        x.gather()
        x.gather(at=(1, 1))
    assert not traffic.active()
    assert counts["all-gather"] == 2 * 64 and counts["ops"] == 2
    assert counts["total"] == 128
    with pytest.raises(ValueError, match="kind"):
        with traffic.count_traffic():
            traffic.report("broadcast", 1)


# ----------------------------------------------------------------------
# the example twins
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["quickstart_torch", "optical_flow_torch"])
def test_example_twin_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].endswith("OK")
