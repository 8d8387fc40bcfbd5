"""Port parity: canonicalization and partition match the reference.

For every Table-I app the port's ``build_schedule`` must give the same
stage topology (kinds, windows, edges), the same fusion-group
membership and the same per-channel halos as
``repro.core.schedule.build_schedule``.  Tiles may differ (the port
fits shared memory on an H100, the reference VMEM on a TPU); the
tile constraints of the port are checked on their own.
"""
from __future__ import annotations

import doctest

import pytest
import torch

torch.set_num_threads(1)

from repro.core import apps as japps                     # noqa: E402
from repro.core.schedule import build_schedule as jbuild  # noqa: E402

import repro_torch.core.schedule as tschedule             # noqa: E402
from repro_torch.core import apps as tapps                # noqa: E402
from repro_torch.core.vectorize import (H100, LANE, ROW_ALIGN,  # noqa: E402
                                        choose_tile, modeled_plane_time,
                                        select_tile)

H, W = 37, 150
APP_NAMES = sorted(japps.APPS)


def _structure(sched) -> dict:
    """Name-free description: channels numbered in first-seen order."""
    ids: dict[int, int] = {}

    def cid(ch) -> int:
        return ids.setdefault(id(ch), len(ids))

    for ch in sched.graph.graph_inputs:
        cid(ch)
    pos = {id(st): i for i, st in enumerate(sched.order)}
    stages = [(st.kind, tuple(st.window), [cid(c) for c in st.inputs],
               [cid(c) for c in st.outputs]) for st in sched.order]
    groups = [sorted(pos[id(st)] for st in g.stages) for g in sched.groups]
    halos = [sorted((cid(c), tuple(h)) for c, h in g.halo.items())
             for g in sched.groups]
    io = [([cid(c) for c in g.inputs], [cid(c) for c in g.outputs],
           [cid(c) for c in g.internal]) for g in sched.groups]
    outs = [(cid(c), c.name) for c in sched.graph.graph_outputs]
    return {"stages": stages, "groups": groups, "halos": halos, "io": io,
            "outputs": outs}


@pytest.mark.parametrize("name", APP_NAMES)
def test_schedule_structure_matches_reference(name):
    ref = _structure(jbuild(japps.build_app(name, H, W)))
    port = _structure(tschedule.build_schedule(tapps.build_app(name, H, W)))
    assert port["stages"] == ref["stages"]
    assert port["groups"] == ref["groups"]
    assert port["io"] == ref["io"]
    assert port["halos"] == ref["halos"]
    assert port["outputs"] == ref["outputs"]


@pytest.mark.parametrize("name", APP_NAMES)
def test_tiles_fit_shared_memory(name):
    sched = tschedule.build_schedule(tapps.build_app(name, 1080, 1920))
    for g in sched.groups:
        th, tw = g.tile
        assert tw % LANE == 0 and th % ROW_ALIGN == 0
        assert g.vector_factor == tw // LANE
        assert g.smem_bytes() <= H100.smem_per_block
        # shared memory only for windows: none without a haloed channel
        assert (g.smem_bytes() > 0) == bool(g.buffered_channels())
        assert modeled_plane_time(g, g.tile) > 0


def test_optical_flow_is_one_group_with_deep_halos():
    sched = tschedule.build_schedule(tapps.build_app("optical_flow_lk",
                                                     1080, 1920))
    (g,) = sched.groups
    assert len(g.stages) == 24
    assert max(h[0] for h in g.halo.values()) == 3
    # every live channel keeps one window; the kernel stores vx, vy
    # straight to device memory
    assert sum(1 for c in g.outputs if g.is_direct(c)) == 2


def test_choose_tile_raises_when_the_factor_cannot_fit():
    g = tschedule.build_schedule(tapps.build_app("filter_chain", H, W)).groups[0]
    with pytest.raises(ValueError, match="vector_factor"):
        choose_tile(g, vector_factor=64)
    assert choose_tile(g, vector_factor=2)[1] == 64
    tile, sweep = select_tile(g)
    assert any(r["feasible"] for r in sweep) and g.tile == tile


def test_schedule_describe_and_doctests():
    sched = tschedule.build_schedule(tapps.build_app("unsharp_mask", H, W))
    text = sched.describe()
    assert "kernel[0] (dataflow)" in text and "[vectorize]" in text
    assert doctest.testmod(tschedule).failed == 0
