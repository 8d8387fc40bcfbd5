"""The hand-built Table-I graphs of the port (``core/handbuilt.py``).

Mirrors the reference's Table-I equivalence cases
(``tests/test_frontend.py``) on the port: every traced app's
canonicalized signature equals its hand-built twin's, and the two
compile to the same outputs, bit for bit (atol 0), on every port
backend on the CPU.  48x256 planes, as the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core.apps import APPS                     # noqa: E402
from repro_torch.core.compiler import compile_graph        # noqa: E402
from repro_torch.core.graph import DataflowGraph           # noqa: E402
from repro_torch.core.handbuilt import HAND_BUILT          # noqa: E402
from repro_torch.core.transform import default_pipeline    # noqa: E402

H, W = 48, 256


def _canonical(g: DataflowGraph) -> DataflowGraph:
    g, _ = default_pipeline().run(g)
    return g


def test_every_table_i_app_has_a_twin():
    assert sorted(HAND_BUILT) == sorted(APPS)


@pytest.mark.parametrize("name", sorted(APPS))
def test_traced_signature_equals_handbuilt(name):
    traced = APPS[name][0](H, W)
    manual = _canonical(HAND_BUILT[name](H, W))
    assert traced.signature() == manual.signature()


@pytest.mark.parametrize("backend", ["torch", "cuda_stream"])
@pytest.mark.parametrize("name", sorted(APPS))
def test_traced_bit_exact_vs_handbuilt(name, backend):
    rng = np.random.default_rng(0)
    traced = APPS[name][0](H, W)
    manual = HAND_BUILT[name](H, W)
    inputs = {c.name: rng.normal(size=c.shape).astype(np.float32)
              for c in traced.graph_inputs}
    out_t = compile_graph(traced, backend=backend, device="cpu")(**inputs)
    out_m = compile_graph(manual, backend=backend, device="cpu")(**inputs)
    assert sorted(out_t) == sorted(out_m)
    for k in out_t:                    # atol=0: bit-exact
        assert torch.equal(out_t[k], out_m[k]), k
