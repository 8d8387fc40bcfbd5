"""Port parity: the tracing frontend.

Programs written against ``repro_torch.frontend`` trace to the graphs
the JAX frontend traces and compute the same outputs (tolerance
|port - jax| <= 1e-5 * max|jax| + 1e-5 * |jax|); trace errors keep the
reference's taxonomy; ``fe.custom`` infers shapes on meta tensors.
"""
from __future__ import annotations

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.frontend as jfe                          # noqa: E402
from repro.frontend.lib import GAUSS3 as JGAUSS3      # noqa: E402

import repro_torch.core.compiler                      # noqa: E402
import repro_torch.frontend as fe                     # noqa: E402
import repro_torch.frontend.ops                       # noqa: E402
import repro_torch.frontend.tracer                    # noqa: E402
import repro_torch.obs.tracer                         # noqa: E402
from repro_torch.frontend.lib import GAUSS3           # noqa: E402

H, W = 40, 160


def _close(port, ref, tol=1e-5):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.all(np.abs(port - ref) <= tol * scale + tol * np.abs(ref))


def _frame(seed=0, shape=(H, W)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_readme_quickstart_matches_jax():
    @fe.dataflow_fn(device="cpu")
    def sharpen(img):
        blur = fe.conv(img, GAUSS3)
        return 2.0 * img - blur

    @jfe.dataflow_fn(backend="xla")
    def jsharpen(img):
        blur = jfe.conv(img, JGAUSS3)
        return 2.0 * img - blur

    x = _frame()
    _close(sharpen(x).numpy(), jsharpen(x))
    app = sharpen.compile(fe.spec((H, W)))
    assert len(app.schedule.groups) == 1 and len(app.kernels) == 1
    assert sharpen.compile(fe.spec((H, W))) is app          # memoized


def _mixed(where, maximum, minimum, sqrt, exp):
    def prog(a, b):
        m = maximum(a, b)
        n = minimum(a, 0.5)
        c = where(a > b, m - n, sqrt(abs(b)))
        d = where((a < 0.0) & (b < 0.0), 1.0, c)
        return {"y": d * 2.0 + exp(minimum(a, 1.0)), "z": -(a / (b * b + 1.0))}
    return prog


@pytest.mark.parametrize("backend", ["torch", "cuda_stream"])
def test_elementwise_library_matches_jax(backend):
    tg = fe.trace(_mixed(fe.where, fe.maximum, fe.minimum, fe.sqrt, fe.exp),
                  (H, W), (H, W))
    jg = jfe.trace(_mixed(jfe.where, jfe.maximum, jfe.minimum, jfe.sqrt,
                          jfe.exp), (H, W), (H, W))
    assert [s.kind for s in tg.toposort()] == [s.kind for s in jg.toposort()]
    ins = {"a": _frame(1), "b": _frame(2)}
    ref = jg.reference_eval(ins)
    app = repro_torch.core.compiler.compile_graph(tg, backend=backend,
                                                  device="cpu")
    out = app(**ins)
    for k in ref:
        _close(out[k].numpy(), ref[k])


def test_int_planes_promote_like_jnp():
    tg = fe.trace(lambda x: x * 2.0 + 1, fe.spec((8, 32), torch.int32))
    jg = jfe.trace(lambda x: x * 2.0 + 1, jfe.spec((8, 32), jnp.int32))
    assert tg.graph_outputs[0].dtype == torch.float32
    assert np.dtype(jg.graph_outputs[0].dtype) == np.float32
    tg2 = fe.trace(lambda x: x * 3, fe.spec((8, 32), torch.int32))
    assert tg2.graph_outputs[0].dtype == torch.int32


def test_custom_infers_shapes_on_meta_tensors():
    def prog(img):
        col = fe.custom(lambda x: x.sum(dim=0, keepdim=True), img)
        return {"col": col, "img2": img * 2.0}

    g = fe.trace(prog, (H, W))
    col = next(c for c in g.graph_outputs if c.name == "col")
    assert col.shape == (1, W) and col.dtype == torch.float32
    app = repro_torch.core.compiler.compile_graph(g, device="cpu")
    x = _frame()
    _close(app(img=x)["col"].numpy(), x.sum(axis=0, keepdims=True))
    assert len(app.schedule.groups) == 2


@pytest.mark.parametrize("prog,err", [
    (lambda x: x if x else x, fe.TraceControlFlowError),
    (lambda x: x[0], fe.TraceLeakError),
    (lambda x: (x > 0) + 1.0, fe.TraceDtypeError),
    (lambda x: np.asarray(x), fe.TraceLeakError),
])
def test_trace_errors_keep_the_taxonomy(prog, err):
    with pytest.raises(err) as ei:
        fe.trace(prog, (H, W))
    assert "test_torch_frontend.py" in str(ei.value)


def test_shape_mismatch_raises():
    with pytest.raises(fe.TraceShapeError):
        fe.trace(lambda a, b: a + b, (H, W), (H, W + 1))


def test_cse_and_fanout_canonicalize():
    def prog(img):
        s = img * 2.0
        t = img * 2.0                     # CSE'd into s
        return fe.conv(s, GAUSS3) + t
    g = fe.trace(prog, (H, W))
    assert any("cse" in line for line in g.frontend_log)
    g.validate()


@pytest.mark.parametrize("module", [
    repro_torch.frontend.tracer, repro_torch.frontend.ops,
    repro_torch.core.compiler, repro_torch.obs.tracer],
    ids=lambda m: m.__name__)
def test_docstring_examples(module):
    result = doctest.testmod(module, verbose=False)
    assert result.attempted > 0 and result.failed == 0
