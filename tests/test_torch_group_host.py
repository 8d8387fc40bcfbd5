"""The generated group kernels' C, run on the host against the plain
version.

The CUDA kernel cannot run here, but its generated source is C++ over a
few CUDA built-ins.  Compiled with ``g++`` against stand-ins for them
(``sg::kThreads`` set to 1, ``__syncthreads()`` a no-op, the ``asm``
copies and loads plain memory reads), with one thread per block, every
pass of a block runs to its end before the next begins: what the
generator's barriers guarantee on the card.  A flat kernel (no window)
has no barrier, and its threads run in turn.  So these tests hold the
generator's indexing, masks, window layout, 16-byte and scalar paths and
register passes against ``stream_group_ref`` on the CPU.  Bit-exact,
except where a stage calls a transcendental function, whose host libm
may round otherwise than torch's CPU kernels (within 1e-6 * max|plain|).
They skip without ``g++``.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import apps as tapps                   # noqa: E402
from repro_torch.core.compiler import compile_graph          # noqa: E402
from repro_torch.core.graph import DataflowGraph, as_dtype   # noqa: E402
from repro_torch.kernels import build                        # noqa: E402
from repro_torch.kernels.expr import C_STORE                  # noqa: E402
from repro_torch.kernels.stream_group import stream_group_ref  # noqa: E402

APP_NAMES = sorted(tapps.APPS)
#: apps whose stages call expf / sqrtf / powf: host libm may differ by an ulp
LIBM_APPS = {"bilateral_filter", "shi_tomasi", "sobel", "sobel_luma"}

SHIM = """#pragma once
#include <math.h>
#include <string.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct host_dim { unsigned x, y, z; };
extern host_dim threadIdx, blockIdx;
inline float __ldg(const float* p) { return *p; }
inline void __syncthreads() {}
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
"""

# the CUDA half types as host C++: bf16 by rounding float's bits to the
# nearest even, f16 through the compiler's _Float16
BF16_SHIM = """#pragma once
#include <stdint.h>
#include <string.h>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.x << 16; float f; memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
"""
F16_SHIM = """#pragma once
struct __half { _Float16 h; };
inline float __half2float(__half v) { return (float)v.h; }
inline __half __float2half(float f) { return {(_Float16)f}; }
"""

# the header's device-only pieces, as plain memory accesses on the host
_HOST_BODIES = {
    r"void cp_async16\(float\* dst, const float\* src\)":
        "{ memcpy(dst, src, 16); }",
    r"void load_wait\(\)": "{}",
    r"float4 ldg4\(const float\* p\)":
        "{ return *reinterpret_cast<const float4*>(p); }",
    r"float4 ldg4_stream\(const float\* p\)":
        "{ return *reinterpret_cast<const float4*>(p); }",
}


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the generated kernels on the host")
    d = tmp_path_factory.mktemp("sg_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cuda_bf16.h").write_text(BF16_SHIM)
    (d / "cuda_fp16.h").write_text(F16_SHIM)
    hdr = (build.CSRC_DIR / "stream_group.cuh").read_text()
    hdr = hdr.replace("constexpr int kThreads = 256;",
                      "constexpr int kThreads = 1;")
    for sig, body in _HOST_BODIES.items():
        hdr, n = re.subn(r"(" + sig + r" )\{.*?\n\}", r"\g<1>" + body, hdr,
                         flags=re.S)
        assert n == 1, sig
    assert "asm" not in hdr
    (d / "stream_group.cuh").write_text(hdr)
    return d


def _host_library(kernel, d):
    """The kernel's generated C with a host loop that runs every block
    (and, for a flat kernel, every thread) in turn."""
    src = kernel.source
    body = src[:src.index('extern "C" int sg_launch')]
    body = body.replace('#include "stream_group.cuh"',
                        '#include "stream_group.cuh"\n'
                        'namespace { alignas(16) float smem[1 << 16]; }')
    g = kernel.group
    store = [C_STORE[kernel.kinds[c]] for c in (*g.inputs, *g.outputs)]
    n_in = len(g.inputs)
    params = ([f"const void* in{k}" for k in range(n_in)]
              + [f"void* out{j}" for j in range(len(g.outputs))])
    args = ", ".join([f"(const {store[k]}*)in{k}" for k in range(n_in)]
                     + [f"({store[n_in + j]}*)out{j}"
                        for j in range(len(g.outputs))]
                     + ["r0", "r1"])
    calls = []
    for batch in ("", ", true"):      # one frame; the batch instance
        call = f"sg_kernel<false{batch}>({args});"
        if "sg_kernel<true>" in src:
            call = f"if (vec) sg_kernel<true{batch}>({args}); else {call}"
        calls.append(call)
    call = f"if (nb > 1) {{ {calls[1]} }} else {{ {calls[0]} }}"
    if kernel.flat:
        grid = ("1u, ((H * W + 3) / 4 + sg::kFlatSteps * sg::kFlatThreads "
                "- 1) / (sg::kFlatSteps * sg::kFlatThreads), "
                "(unsigned)sg::kFlatThreads")
    else:
        grid = "(H + TH - 1) / TH, (W + TW - 1) / TW, 1u"
    program = body + f"""
host_dim threadIdx, blockIdx;
extern "C" void run({', '.join(params)}, int r0, int r1, int vec,
                    int nb) {{
  const unsigned n[3] = {{{grid}}};
  for (unsigned bz = 0; bz < (unsigned)nb; ++bz)
  for (unsigned by = 0; by < n[0]; ++by)
    for (unsigned bx = 0; bx < n[1]; ++bx)
      for (unsigned tx = 0; tx < n[2]; ++tx) {{
        blockIdx = {{bx, by, bz}};
        threadIdx = {{tx, 0, 0}};
        {call}
      }}
}}
"""
    tag = hashlib.sha256(program.encode()).hexdigest()[:16]
    so = d / f"sg_{tag}.so"
    if not so.exists():
        cpp = d / f"sg_{tag}.cpp"
        cpp.write_text(program)
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", f"-I{d}", "-o", str(so),
                        str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = ([ctypes.c_void_p] * (len(g.inputs) + len(g.outputs))
                        + [ctypes.c_int] * 4)
    return lib


def _plane(dtype, shape, rng):
    """A seeded plane of ``dtype``: normal floats, ints in [-60, 60),
    bools."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-60, 60, size=shape,
                                             dtype=np.int32))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(dtype)


def _poisoned(dtype, shape):
    """An output buffer every element of which the kernel must write."""
    fill = {torch.bool: True, torch.int32: -12345}.get(dtype, float("nan"))
    return torch.full(shape, fill, dtype=dtype)


def _check(kernel, d, exact, seed=0):
    H, W = kernel.plane
    lib = _host_library(kernel, d)
    rng = np.random.default_rng(seed)
    xs = [_plane(as_dtype(c.dtype), (H, W), rng) for c in kernel.group.inputs]
    for rows in (None, (3, H - 4)):
        want = stream_group_ref(kernel.group, xs, rows)
        for vec in (1, 0):
            outs = [_poisoned(as_dtype(c.dtype), (H, W))
                    for c in kernel.group.outputs]
            r0, r1 = rows or (0, H)
            lib.run(*[t.data_ptr() for t in (*xs, *outs)], r0, r1, vec, 1)
            for o, r in zip(outs, want):
                if exact:
                    assert torch.equal(o, r), (rows, vec)
                else:
                    scale = float(r.abs().max())
                    assert float((o - r).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("shape", [(37, 61), (40, 96)])
@pytest.mark.parametrize("name", APP_NAMES)
def test_generated_kernel_matches_plain_version_on_host(name, shape,
                                                       host_dir):
    """(37, 61): odd width, the scalar instance; (40, 96): the 16-byte
    instance (vec=1) and the scalar one (vec=0); both with partial
    tiles and with a valid row band."""
    (kernel,) = tapps.compile_app(name, *shape, device="cpu").kernels
    _check(kernel, host_dir, exact=name not in LIBM_APPS)


@pytest.mark.parametrize("shape", [(37, 61), (16, 64)])
def test_flat_group_with_split_arms_matches_on_host(shape, host_dir):
    """A window-free group whose input feeds two stages (an auto-split:
    its arms are row-masked, the input is not) and with two outputs, one
    of them an intermediate the group also reads."""
    g = DataflowGraph("flat_split")
    x = g.input("x", shape)
    z = g.input("z", shape)
    a = g.point(x, lambda v: v * 2.0)
    b = g.point(x, lambda v: v + 1.0)
    g.output(g.pointn([a, b, z], lambda p, q, r: p * q - r), "out")
    g.output(a, "a")
    (kernel,) = compile_graph(g, backend="cuda_stream", device="cpu").kernels
    assert kernel.flat and kernel.smem_bytes == 0
    assert any(st.kind == "split" for st in kernel.group.stages)
    _check(kernel, host_dir, exact=True, seed=1)


def test_halo_free_input_beside_a_window_matches_on_host(host_dir):
    """A group with a window (the stencil's input) and a halo-free input
    read straight from device memory in the centre pass, whose steps'
    loads are all issued before the first computes."""
    g = DataflowGraph("direct_input")
    x = g.input("x", (40, 96))
    z = g.input("z", (40, 96))
    blur = g.stencil(x, (3, 3), lambda p: (p[1] + p[3] + p[5] + p[7]) * 0.25)
    g.output(g.pointn([blur, z], lambda b, w: b * w + 1.0), "out")
    (kernel,) = compile_graph(g, backend="cuda_stream", device="cpu").kernels
    assert not kernel.flat and kernel.barriers == 1
    assert kernel.source.count("sg::load_window<") == 1
    assert kernel.source.count("sg::load4<") == 1
    _check(kernel, host_dir, exact=True, seed=2)


@pytest.mark.parametrize("shape", [(37, 61), (40, 96)])
@pytest.mark.parametrize("name", ["square", "unsharp_mask",
                                  "optical_flow_lk"])
def test_batched_kernel_matches_each_frame_on_host(name, shape, host_dir):
    """Three frames in one launch (blockIdx.z the frame): every frame
    equals the plain version of that frame alone, on the flat route
    (square) and the tiled one, 16-byte and scalar."""
    (kernel,) = tapps.compile_app(name, *shape, device="cpu").kernels
    H, W = shape
    lib = _host_library(kernel, host_dir)
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.standard_normal((3, H, W)).astype(np.float32))
          for _ in kernel.group.inputs]
    # the wrapper takes 16-byte accesses only where W % 4 == 0: then
    # every frame's base is 16-byte aligned too
    for vec in ((1, 0) if W % 4 == 0 else (0,)):
        outs = [torch.full((3, H, W), float("nan"))
                for _ in kernel.group.outputs]
        lib.run(*[t.data_ptr() for t in (*xs, *outs)], 2, H - 1, vec, 3)
        for b in range(3):
            want = stream_group_ref(kernel.group, [x[b] for x in xs],
                                    (2, H - 1))
            for o, r in zip(outs, want):
                assert torch.equal(o[b], r), (b, vec)


@pytest.mark.parametrize("shape", [(37, 61), (40, 96)])
def test_int_and_bool_channels_match_on_host(shape, host_dir):
    """The typed program of ``tests/test_torch_kernel.py`` (int32 windows
    with floor division and modulo, a one-byte bool window, where, abs,
    maximum, bitwise ops, int -> float32 -> int casts): every group's
    generated C against the plain version, bit for bit, 16-byte (4-byte
    for bool) and scalar paths."""
    from test_torch_kernel import typed_graph
    g = typed_graph(DataflowGraph, torch, torch.int32, torch.bool,
                    torch.float32, shape)
    app = compile_graph(g, backend="cuda_stream", device="cpu")
    kinds = set()
    for kernel in app.kernels:
        kinds |= set(kernel.kinds.values())
        _check(kernel, host_dir, exact=True, seed=6)
    assert {"i", "b"} <= kinds


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_channels_match_on_host(dtype, host_dir):
    """bf16 and f16 planes: windows of 2-byte values, each op computed in
    float32 and rounded to the plane's type, a float32 channel beside
    them; bit for bit against the plain version (no transcendental
    function, constants exact in the type)."""
    g = DataflowGraph("half")
    x = g.input("x", (40, 96), dtype)
    z = g.input("z", (40, 96), torch.float32)
    blur = g.stencil(x, (3, 3), lambda p: (p[1] + p[3] + p[5] + p[7]) * 0.25
                     - p[4] * 0.5, name="blur")
    mix = g.pointn([blur, x], lambda b, v: torch.maximum(b, v) * 3.0
                   + torch.sqrt(torch.abs(v)), name="mix")
    g.output(mix, "mix")
    g.output(g.pointn([mix, z], lambda m, w: m * w, dtype=torch.float32),
             "wide")
    (kernel,) = compile_graph(g, backend="cuda_stream", device="cpu").kernels
    assert sorted(set(kernel.kinds.values())) == sorted(
        {"f", {torch.bfloat16: "bf", torch.float16: "hf"}[dtype]})
    _check(kernel, host_dir, exact=True, seed=7)
