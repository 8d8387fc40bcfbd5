"""The group kernel's generator, recorder and wrapper.

On the CPU: the expression recorder's DAG, evaluated with torch, equals
each stage body applied to tensors (bit for bit, same op order); the
CUDA source is generated for every app with no nvcc present; stages the
recorder cannot express raise the typed error; the source takes a
batch axis on both routes (``blockIdx.z`` the frame, ``B`` in the
launcher's arguments); the wrapper takes the plain version for CPU
tensors, frame by frame for a batch, and counts no launch.  Tests marked
``gpu`` build and launch the kernel and hold it against the plain
version on the card (max abs error <= 1e-6 * max|plain|, expected 0
with ``-fmad=false``), and a batch of 8 frames against 8 single-frame
launches bit for bit; they skip without a card.
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
from repro_torch.core.schedule import pad4                  # noqa: E402
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
    n_args = len(g.inputs) + len(g.outputs) + 5   # r0, r1, vec, B, stream
    sig = re.search(r'extern "C" int sg_launch\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == n_args
    assert "int B" in [a.strip() for a in sig.split(",")]
    # a window for each group input with a halo; the halo-free ones are
    # read straight from device memory in the centre pass
    windowed = [c for c in g.inputs if g.halo.get(c, (0, 0)) != (0, 0)]
    assert src.count("sg::load_window<") == len(windowed)
    assert (src.count("sg::load4<") + src.count("sg::load4_flat<")
            == len(g.inputs) - len(windowed))
    assert src.count("__syncthreads();") == kernel.barriers
    assert kernel.barriers >= (1 if kernel.smem_bytes else 0)
    assert f"SMEM_BYTES = {kernel.smem_bytes};" in src
    assert kernel.smem_bytes <= 232448
    assert "powf" not in src             # integer powers are multiplies
    assert build.library_path("sg", src).name.startswith("sg_")


@pytest.mark.parametrize("name", ["square", "unsharp_mask",
                                  "optical_flow_lk"])
def test_source_takes_a_batch_axis_on_both_routes(name):
    """One source for one frame and for B: the grid's z axis is the
    frame, every pointer moves to its frame first (64-bit), on the flat
    route (square) and the tiled one."""
    (kernel,) = tapps.compile_app(name, 1080, 1920, device="cpu").kernels
    src = kernel.source
    g = kernel.group
    assert kernel.flat == (name == "square")
    assert ("const size_t frame = (size_t)blockIdx.z * ((size_t)H * W);"
            in src)
    for k in range(len(g.inputs)):
        assert f"in{k} += frame;" in src
    for j in range(len(g.outputs)):
        assert f"out{j} += frame;" in src
    grid = re.search(r"const dim3 grid\((.*)\);", src).group(1)
    assert grid.endswith(", B")
    assert ("blockIdx.y" in src) != kernel.flat


def test_batched_frames_on_cpu_take_the_plain_version_frame_by_frame():
    (kernel,) = tapps.compile_app("unsharp_mask", H, W, device="cpu").kernels
    gen = torch.Generator().manual_seed(5)
    xs = [torch.randn(3, H, W, generator=gen) for _ in kernel.group.inputs]
    before = stream_group.launches
    (out,) = stream_group(kernel, xs, (2, H - 3))
    assert stream_group.launches == before      # no kernel on the CPU
    assert out.shape == (3, H, W)
    for b in range(3):
        (one,) = stream_group_ref(kernel.group, [x[b] for x in xs],
                                  (2, H - 3))
        assert torch.equal(out[b], one)


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


def typed_graph(G, xp, i32, b8, f32, shape):
    """One program over int32 planes, in either package (``G`` its
    ``DataflowGraph``, ``xp`` its array module): an int window with floor
    division and modulo of negative values, a bool mask, a window over the
    mask (a one-byte window), where / abs / maximum / bitwise ops, true
    division to float32 and a float32 result cast back to int32."""
    g = G("typed")
    x = g.input("x", shape, i32)
    y = g.input("y", shape, i32)
    s = g.stencil(x, (3, 3), lambda p: p[1] * 3 - p[3] // 4 + p[5] % -3
                  - p[7] // -5 + p[4] % 7, name="ints")
    m = g.pointn([s, y], lambda a, b: (a > b) ^ (b < 0), dtype=b8,
                 name="mask")
    e = g.stencil(m, (3, 3), lambda p: (p[1] | p[7]) & ~p[4], dtype=b8,
                  name="edge")
    q = g.pointn([s, e, y], lambda a, f, b: xp.where(
        f, xp.abs(a), xp.maximum(b, a) // 2) ^ (b & 6), name="pick")
    r = g.point(q, lambda v: v / 4, dtype=f32, name="ratio")
    back = g.point(r, lambda v: v * 2.5 - 1.0, dtype=i32, name="back")
    for ch, name in ((q, "q"), (e, "edge"), (r, "ratio"), (back, "back")):
        g.output(ch, name)
    return g


def typed_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(-60, 60, size=shape).astype(np.int32)
            for n in ("x", "y")}


def test_non_float32_channels_are_refused():
    """int32 and bool channels run on the group kernel's route: the plain
    version against the JAX group kernel (interpret mode) and against
    ``reference_eval``, exact; int64 (no kernel type) is still refused."""
    from repro_torch.core import graph as TG
    shape = (H, W)
    g = typed_graph(TG.DataflowGraph, torch, torch.int32, torch.bool,
                    torch.float32, shape)
    app = compile_graph(g, backend="cuda_stream", device="cpu")
    kinds = {str(k.kinds[c]) for k in app.kernels for c in k.kinds}
    assert {"i", "b", "f"} <= kinds
    xs = typed_inputs(shape)
    got = app(**{n: torch.from_numpy(v) for n, v in xs.items()})
    ref = g.reference_eval({n: torch.from_numpy(v) for n, v in xs.items()})
    want_dtypes = {"q": torch.int32, "edge": torch.bool,
                   "ratio": torch.float32, "back": torch.int32}
    for name, dtype in want_dtypes.items():
        assert got[name].dtype == dtype
        assert torch.equal(got[name], ref[name]), name
    assert bool(got["edge"].any()) and not bool(got["edge"].all())
    try:
        import jax.numpy as jnp
        from repro.core import graph as JG
        from repro.core.compiler import compile_graph as j_compile
    except ImportError:
        jnp = None
    if jnp is not None:                 # the card's machine has no JAX
        jg = typed_graph(JG.DataflowGraph, jnp, jnp.int32, jnp.bool_,
                         jnp.float32, shape)
        jout = j_compile(jg, backend="pallas")(**xs)
        for name, dtype in want_dtypes.items():
            want = np.asarray(jout[name])
            assert want.dtype == np.dtype(str(dtype).removeprefix("torch."))
            np.testing.assert_array_equal(got[name].numpy(), want)
    g64 = DataflowGraph("int64")
    x = g64.input("img", (H, W), torch.int64)
    g64.output(g64.point(x, lambda v: v + 1), "out")
    with pytest.raises(UnsupportedBackendError, match="int64"):
        compile_graph(g64, backend="cuda_stream", device="cpu")


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
# the generated kernel's shape: registers for halo-free channels, barriers
# only where a pass reads another thread's window, 16-byte accesses
# ----------------------------------------------------------------------
def _pr15_smem_bytes(g) -> int:
    """Shared memory of the kernel before halo-free channels moved to
    registers: a (th+2hy) x (tw+2hx) window for every group input and
    every stage output but split arms and direct outputs."""
    th, tw = g.tile
    chans = list(g.inputs) + [c for st in g.stages if st.kind != "split"
                              for c in st.outputs if not g.is_direct(c)]
    return sum((th + 2 * g.halo.get(c, (0, 0))[0])
               * (tw + 2 * g.halo.get(c, (0, 0))[1]) * 4 for c in chans)


@pytest.mark.parametrize("shape", [(1080, 1920), (37, 61)])
def test_square_streams_without_shared_memory(shape):
    """No halo, no window: the plane streams flat, 16-byte chunks at any
    width (a chunk may span two rows)."""
    (kernel,) = tapps.compile_app("square", *shape, device="cpu").kernels
    src = kernel.source
    assert kernel.smem_bytes == 0 and kernel.group.buffered_channels() == []
    assert "__shared__" not in src and "__syncthreads" not in src
    assert "sg::load_window<" not in src and kernel.barriers == 0
    assert kernel.flat and "sg::kFlatThreads" in src
    assert src.count("sg::load4_flat<") == 1
    assert src.count("sg::store4_flat<") == 1
    assert "sg_kernel<true>" in src and "sg_kernel<false>" in src


# barriers: one after the input windows are copied (the first stencils read
# them), one before the centre pass (its 5x5 stencils read the windows the
# pointwise stages wrote); the pointwise stages between read windows of
# their own halo, written element for element by the same thread
@pytest.mark.parametrize("name,barriers", [("optical_flow_lk", 2),
                                           ("harris", 2), ("shi_tomasi", 2)])
def test_deep_groups_keep_halo_free_channels_in_registers(name, barriers):
    (kernel,) = tapps.compile_app(name, 1080, 1920, device="cpu").kernels
    g = kernel.group
    halo = {c: g.halo.get(c, (0, 0)) for c in g.halo}
    halo_free = [c for st in g.stages if st.kind != "split"
                 for c in st.outputs if halo.get(c, (0, 0)) == (0, 0)
                 and c in g.internal]
    assert halo_free                       # 5 or 3 such intermediates
    assert not set(halo_free) & set(g.buffered_channels())
    assert all(halo[c] != (0, 0) for c in g.buffered_channels())
    # smem drops by the halo-free windows, and grows only by the columns
    # that round each remaining window's margin up to 4 floats
    th, tw = g.tile
    freed = len(halo_free) * th * tw * 4
    padding = sum((th + 2 * halo[c][0]) * 2 * (pad4(halo[c][1]) - halo[c][1])
                  * 4 for c in g.buffered_channels())
    assert kernel.smem_bytes == _pr15_smem_bytes(g) - freed + padding
    assert kernel.smem_bytes < _pr15_smem_bytes(g)
    assert kernel.barriers == barriers
    assert kernel.source.count("__syncthreads();") == barriers


def test_odd_width_plane_generates_the_scalar_path():
    (odd,) = tapps.compile_app("unsharp_mask", 37, 61, device="cpu").kernels
    (even,) = tapps.compile_app("unsharp_mask", 64, 160,
                                device="cpu").kernels
    # W % 4 != 0: rows are not 16-byte aligned, only the scalar instance
    assert "sg_kernel<false>" in odd.source
    assert "sg_kernel<true>" not in odd.source
    assert "(void)vec;" in odd.source
    # W % 4 == 0: the float4 instance where the wrapper finds the pointers
    # aligned, the scalar one otherwise
    assert "if (vec) {" in even.source
    assert "sg_kernel<true>" in even.source and "sg_kernel<false>" in even.source


def test_window_margins_are_rounded_to_16_bytes():
    for h in range(9):
        assert pad4(h) % 4 == 0 and h <= pad4(h) < h + 4
    (kernel,) = tapps.compile_app("filter_chain", 1080, 1920,
                                  device="cpu").kernels
    g = kernel.group
    th, tw = g.tile
    assert kernel.smem_bytes == sum(
        (th + 2 * g.halo[c][0]) * (tw + 2 * pad4(g.halo[c][1])) * 4
        for c in g.buffered_channels())


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


@pytest.mark.gpu
@pytest.mark.parametrize("name", APP_NAMES)
def test_kernel_matches_plain_version_on_ragged_plane_on_card(name):
    """1079x1917: an odd width (no 16-byte rows: the scalar instance, or
    flat chunks across rows for square) and partial tiles on both edges;
    max abs error 0 expected."""
    _needs_card()
    app = tapps.compile_app(name, 1079, 1917)
    (kernel,) = app.kernels
    assert kernel.flat or "sg_kernel<true>" not in kernel.source
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(1079, 1917, device="cuda", generator=gen)
          for _ in kernel.group.inputs]
    out = stream_group(kernel, xs)
    ref = stream_group_ref(kernel.group, xs)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        scale = float(r.abs().max().clamp_min(1e-30))
        assert float((o - r).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["square", "unsharp_mask", "sobel_luma"])
def test_misaligned_inputs_take_the_scalar_instance_on_card(name):
    _needs_card()
    (kernel,) = tapps.compile_app(name, 64, 160).kernels
    gen = torch.Generator(device="cuda").manual_seed(2)
    xs = []
    for _ in kernel.group.inputs:
        flat = torch.randn(64 * 160 + 1, device="cuda", generator=gen)
        xs.append(flat[1:].view(64, 160))      # data 4 bytes past 16
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in xs)
    out = stream_group(kernel, xs)
    ref = stream_group_ref(kernel.group, xs)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", [(1080, 1920), (1079, 1917)],
                         ids=["1080x1920", "1079x1917"])
@pytest.mark.parametrize("name", ["square", "unsharp_mask",
                                  "optical_flow_lk"])
def test_batch_of_8_equals_8_single_frame_launches_on_card(name, plane):
    """A flat, a stencil and a deep group: B = 8 frames in one launch
    are bit-identical to 8 launches of one frame each, with and without
    a valid row band."""
    _needs_card()
    (kernel,) = tapps.compile_app(name, *plane).kernels
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = [torch.randn(8, *plane, device="cuda", generator=gen)
          for _ in kernel.group.inputs]
    for rows in (None, (5, plane[0] - 9)):
        before = stream_group.launches
        batched = stream_group(kernel, xs, rows)
        assert stream_group.launches == before + 1
        for b in range(8):
            single = stream_group(kernel, [x[b] for x in xs], rows)
            for o, s in zip(batched, single):
                assert torch.equal(o[b], s), (b, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1080, 1920), (1079, 1917)],
                         ids=["1080x1920", "1079x1917"])
def test_int_and_bool_channels_match_plain_on_card(shape):
    """The typed program (int32 windows, a one-byte bool window, int ->
    float32 -> int) through ``cuda_stream`` on the card: every output in
    its channel's type, bit for bit against the plain version, one launch
    a group; the 16-byte (4-byte for bool) instance at 1080x1920, the
    scalar one at the odd width."""
    _needs_card()
    from repro_torch.core import graph as TG
    g = typed_graph(TG.DataflowGraph, torch, torch.int32, torch.bool,
                    torch.float32, shape)
    app = compile_graph(g, backend="cuda_stream")
    xs = {n: torch.from_numpy(v).cuda()
          for n, v in typed_inputs(shape, seed=3).items()}
    before = stream_group.launches
    got = app(**xs)
    torch.cuda.synchronize()
    assert stream_group.launches - before == len(app.kernels)
    ref = g.reference_eval(xs)
    for name, want in ref.items():
        assert got[name].dtype == want.dtype and got[name].is_cuda
        assert torch.equal(got[name], want), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_channels_match_plain_on_card(dtype):
    """bf16 / f16 windows and a float32 channel beside them: each op
    rounded to the plane's type, bit for bit against the plain version
    (no transcendental function)."""
    _needs_card()
    g = DataflowGraph("half")
    x = g.input("x", (1080, 1920), dtype)
    blur = g.stencil(x, (3, 3), lambda p: (p[1] + p[3] + p[5] + p[7]) * 0.25
                     - p[4] * 0.5)
    g.output(g.pointn([blur, x], lambda b, v: torch.maximum(b, v) * 3.0
                      + torch.sqrt(torch.abs(v))), "mix")
    (kernel,) = compile_graph(g, backend="cuda_stream").kernels
    gen = torch.Generator(device="cuda").manual_seed(4)
    xs = [torch.randn(1080, 1920, device="cuda", generator=gen).to(dtype)]
    (out,) = stream_group(kernel, xs)
    (ref,) = stream_group_ref(kernel.group, xs)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, ref)
