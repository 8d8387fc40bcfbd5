"""The group kernel's generator, recorder and wrapper.

On the CPU: the expression recorder's DAG, evaluated with torch, equals
each stage body applied to tensors (bit for bit, same op order); the
CUDA source is generated for every app with no nvcc present; stages the
recorder cannot express raise the typed error; the wrapper takes the
plain version for CPU tensors and counts no launch.  Tests marked
``gpu`` build and launch the kernel and hold it against the plain
version on the card (max abs error <= 1e-6 * max|plain|, expected 0
with ``-fmad=false``); they skip without a card.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.backends import UnsupportedBackendError   # noqa: E402
from repro_torch.core import apps as tapps                  # noqa: E402
from repro_torch.core.compiler import compile_graph         # noqa: E402
from repro_torch.core.graph import DataflowGraph, extract_patches  # noqa: E402
from repro_torch.kernels import build                       # noqa: E402
from repro_torch.kernels.expr import (Expr, Patches, RecordError,  # noqa: E402
                                      c_float, emit_c, evaluate)
from repro_torch.kernels.stream_group import (stream_group,  # noqa: E402
                                              stream_group_ref)

H, W = 37, 150
APP_NAMES = sorted(tapps.APPS)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


@pytest.mark.parametrize("name", APP_NAMES)
def test_recorded_dag_equals_stage_body(name):
    app = tapps.compile_app(name, H, W, device="cpu")
    (kernel,) = app.kernels
    rng = np.random.default_rng(3)
    for st in kernel.group.stages:
        if st.kind == "split":
            continue
        xs = [torch.from_numpy(rng.standard_normal((H, W)).astype(np.float32))
              for _ in st.inputs]
        if st.kind == "stencil":
            patches = extract_patches(xs[0], st.window)
            kh, kw = st.window
            want = st.fn(patches)

            def leaf(k, dy, dx, patches=patches, kh=kh, kw=kw):
                return patches[(dy + (kh - 1) // 2) * kw + dx + (kw - 1) // 2]
        else:
            want = st.fn(*xs)

            def leaf(k, dy, dx, xs=xs):
                return xs[k]
        got = evaluate(kernel.exprs[id(st)], leaf)
        assert torch.equal(got, want), st.name


@pytest.mark.parametrize("name", APP_NAMES)
def test_source_generates_without_nvcc(name, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "CUDA_NVCC", build.BUILD_DIR / "no-nvcc")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()
    app = tapps.compile_app(name, 1080, 1920, device="cpu")
    (kernel,) = app.kernels
    src = kernel.source
    g = kernel.group
    n_args = len(g.inputs) + len(g.outputs) + 3
    sig = re.search(r'extern "C" int sg_launch\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == n_args
    assert src.count("sg::load_window<") == len(g.inputs)
    assert src.count("__syncthreads();") >= 1
    assert f"SMEM_BYTES = {kernel.smem_bytes};" in src
    assert kernel.smem_bytes <= 232448
    assert "powf" not in src             # integer powers are multiplies
    assert build.library_path("sg", src).name.startswith("sg_")


def test_integer_power_is_emitted_as_multiplies():
    p = Patches(0, (1, 1))
    lines, res = emit_c(p[0] ** 2, lambda k, dy, dx: "x")
    assert lines[-1].endswith("= (t0 * t0);") and "pow" not in "".join(lines)
    lines, _ = emit_c(p[0] ** 3, lambda k, dy, dx: "x")
    assert sum(ln.count("*") for ln in lines) == 2
    x = torch.randn(5)
    for n in (2, 3, 5, -2):
        got = evaluate(p[0] ** n, lambda k, dy, dx: x)
        torch.testing.assert_close(got, x ** n, rtol=2e-7, atol=0)


@pytest.mark.parametrize("v", [0.299, -1.0, 1e-12, 1.0 / 16, 3.4e38, -0.0])
def test_constants_are_exact_hex_floats(v):
    lit = c_float(v)
    assert float.fromhex(lit.strip("()").rstrip("f")) == float(np.float32(v))


def test_recorder_handles_torch_math_and_masks():
    a, b = Expr("in", (0, 0, 0), "f"), Expr("in", (1, 0, 0), "f")
    e = torch.where((a > 0.5) & ~(b < -1.0),
                    torch.maximum(torch.exp(a), torch.clamp(b, min=0.0)),
                    torch.sign(torch.abs(b) - 2.0))
    xa = torch.tensor([0.0, 1.0, 2.0, float("nan")])
    xb = torch.tensor([-2.0, 0.5, -3.0, 1.0])
    want = torch.where((xa > 0.5) & ~(xb < -1.0),
                       torch.maximum(torch.exp(xa), torch.clamp(xb, min=0.0)),
                       torch.sign(torch.abs(xb) - 2.0))
    got = evaluate(e, lambda k, dy, dx: (xa, xb)[k])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    lines, _ = emit_c(e, lambda k, dy, dx: f"v{k}")
    body = "\n".join(lines)
    assert "expf(" in body and "sg::fmax_nan(" in body and "?" in body
    with pytest.raises(RecordError):
        bool(a > 0)
    with pytest.raises(RecordError):
        torch.fft.fft(a)


def test_unrecordable_stage_raises_typed_error_naming_it():
    g = DataflowGraph("opaque")
    x = g.input("img", (H, W))
    y = g.stencil(x, (3, 3), lambda p: torch.median(p, dim=0).values,
                  name="median_body")
    g.output(y, "out")
    with pytest.raises(UnsupportedBackendError, match="median_body"):
        compile_graph(g, backend="cuda_stream", device="cpu")
    # the torch backends still run it
    app = compile_graph(g, backend="torch", device="cpu")
    assert app(img=torch.ones(H, W))["out"].shape == (H, W)


def test_non_float32_channels_are_refused():
    g = DataflowGraph("ints")
    x = g.input("img", (H, W), torch.int32)
    g.output(g.point(x, lambda v: v + 1), "out")
    with pytest.raises(UnsupportedBackendError, match="float32"):
        compile_graph(g, backend="cuda_stream", device="cpu")


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    app = tapps.compile_app("unsharp_mask", H, W, device="cpu")
    (kernel,) = app.kernels
    x = torch.randn(H, W, generator=torch.Generator().manual_seed(0))
    before = stream_group.launches
    out = stream_group(kernel, [x], (2, 30))
    assert stream_group.launches == before
    ref = stream_group_ref(kernel.group, [x], (2, 30))
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    with pytest.raises(ValueError, match="one device"):
        stream_group(kernel, [x, x.to("meta")])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("name", APP_NAMES)
def test_kernel_matches_plain_version_on_card(name):
    _needs_card()
    app = tapps.compile_app(name, H, W)
    (kernel,) = app.kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(H, W, device="cuda", generator=gen)
          for _ in kernel.group.inputs]
    for rows in (None, (4, 31)):
        before = stream_group.launches
        out = stream_group(kernel, xs, rows)
        torch.cuda.synchronize()
        assert stream_group.launches == before + 1
        ref = stream_group_ref(kernel.group, xs, rows)
        for o, r in zip(out, ref):
            scale = float(r.abs().max().clamp_min(1e-30))
            assert float((o - r).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_app_on_card_counts_one_launch_per_group():
    _needs_card()
    app = tapps.compile_app("optical_flow_lk", H, W)
    before = stream_group.launches
    out = app(f1=torch.randn(H, W), f2=torch.randn(H, W))
    torch.cuda.synchronize()
    assert stream_group.launches - before == len(app.schedule.groups)
    assert all(v.is_cuda and torch.isfinite(v).all() for v in out.values())
