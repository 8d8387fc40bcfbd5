"""Port parity: graph IR, reference semantics and coefficient tables.

The same numpy inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (PyTorch, CPU).  Tolerance for whole-app reference
outputs: |port - jax| <= 1e-5 * max|jax| + 1e-5 * |jax| (XLA's CPU
transcendentals and contraction differ from PyTorch's in the last bits).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.frontend.lib as jlib                       # noqa: E402
from repro.core import apps as japps                    # noqa: E402
from repro.core.graph import DataflowGraph as JGraph    # noqa: E402
from repro.core.graph import extract_patches as jpatches  # noqa: E402

import repro_torch.frontend.lib as tlib                 # noqa: E402
from repro_torch.core import apps as tapps              # noqa: E402
from repro_torch.core.graph import (ChannelContractError, CycleError,  # noqa: E402
                                    DataflowGraph, as_inputs,
                                    extract_patches, window_rows)

H, W = 37, 150          # ragged on purpose: neither a tile nor a lane multiple
APP_NAMES = sorted(japps.APPS)


def _close(port: np.ndarray, ref: np.ndarray, tol: float = 1e-5) -> float:
    """Max error relative to the reference's max abs; asserts tolerance."""
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = np.abs(port - ref)
    assert np.all(err <= tol * scale + tol * np.abs(ref)), \
        f"max rel err {err.max() / scale:.3e}"
    return float(err.max() / scale)


def _inputs(graph, seed=0):
    rng = np.random.default_rng(seed)
    return {c.name: rng.standard_normal(c.shape).astype(np.float32)
            for c in graph.graph_inputs}


def test_tables_are_bit_equal_to_the_reference():
    tables = tlib.tables()
    assert set(tables) == {"GAUSS3", "GAUSS5", "MEAN5", "SOBEL_X",
                           "SOBEL_Y", "LAPLACE3", "JACOBI3"}
    for name, table in tables.items():
        ref = getattr(jlib, name)
        assert table.dtype == ref.dtype == np.float32
        assert table.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("window", [(1, 1), (3, 3), (5, 5), (3, 5)])
def test_extract_patches_matches_reference(window):
    x = np.random.default_rng(1).standard_normal((H, W)).astype(np.float32)
    ref = np.asarray(jpatches(x, window))
    port = extract_patches(torch.from_numpy(x), window).numpy()
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("name", APP_NAMES)
def test_reference_eval_matches_jax(name):
    jg = japps.build_app(name, H, W)
    tg = tapps.build_app(name, H, W)
    ins = _inputs(jg)
    ref = jg.reference_eval(ins)
    out = tg.reference_eval(as_inputs(tg, ins, "cpu"))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k].numpy(), np.asarray(ref[k]))


def test_as_inputs_places_and_casts():
    g = tapps.build_app("sobel_luma", 8, 32)
    arrays = {c.name: np.ones((8, 32), np.float64) for c in g.graph_inputs}
    ins = as_inputs(g, arrays, "cpu")
    assert sorted(ins) == ["b", "g", "r"]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in ins.values())
    with pytest.raises(Exception, match="missing graph input"):
        as_inputs(g, {"r": arrays["r"]}, "cpu")


def test_window_rows_zeroes_outside_band():
    x = torch.ones(6, 4)
    y = window_rows(x, (1, 4))
    assert y[:1].abs().sum() == 0 and y[4:].abs().sum() == 0
    assert torch.equal(y[1:4], x[1:4])
    v = torch.ones(3)
    assert window_rows(v, (0, 1)) is v


def _contract_cases(graph_cls):
    g1 = graph_cls("multi")
    x = g1.input("x", (4, 4))
    g1.point(x, lambda v: v)
    g1.point(x, lambda v: v)
    g2 = graph_cls("cycle")
    a = g2.channel((4, 4))
    b = g2.channel((4, 4))
    g2.task("p", "point", lambda v: v, [a], [b])
    g2.task("q", "point", lambda v: v, [b], [a])
    g2.output(b)
    return g1, g2


def test_validation_errors_match_reference():
    jmulti, jcycle = _contract_cases(JGraph)
    tmulti, tcycle = _contract_cases(DataflowGraph)
    for jg, tg, err in ((jmulti, tmulti, ChannelContractError),
                        (jcycle, tcycle, CycleError)):
        with pytest.raises(Exception) as je:
            jg.validate()
        with pytest.raises(err) as te:
            tg.validate()
        assert type(je.value).__name__ == type(te.value).__name__


def test_signature_is_stable_across_traces_and_relabels():
    a = tapps.build_app("harris", H, W)
    b = tapps.build_app("harris", H, W)
    assert a.signature() == b.signature()
    for ch in b.channels:
        if not (ch.is_graph_input or ch.is_graph_output):
            ch.name = "renamed_" + ch.name
    assert a.signature() == b.signature()
    assert a.signature() != tapps.build_app("shi_tomasi", H, W).signature()
