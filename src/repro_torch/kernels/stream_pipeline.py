"""The fused pointwise stage chain: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``stream_pipeline`` / ``_kernel``
(``src/repro/kernels/stream_pipeline.py``): a chain of pointwise stage
functions over a 2-D plane in one pass, one read and one write of the
plane for the whole chain.  ``stream_pipeline_staged`` is the baseline
without dataflow, one read and one write per stage.

The kernel's fixed part is hand-written in ``csrc/stream_pipeline.cuh``
(16-byte loads, 1, 2 or 4 issued a thread before the chain runs on
them in registers, as :func:`unroll` picks, and a grid sized from the
plane); per chain and plane type, :class:`PipelineKernel` records every
stage once with :mod:`repro_torch.kernels.expr` and emits the chain as
C.  A plane may be float32, bfloat16, float16, int32 or bool; each op on
a bf16 or f16 plane computes in float32 and rounds its result to the
plane's type, as torch and JAX do op by op.  A comparison's bool stays
bool into the next stage; only the chain's final value is converted to
the plane's type, as the reference's ``_kernel`` does.  What bounds it
on the card: the bytes, twice the plane's element size per element.

For pointwise stages the result depends on neither the tile nor the
padding, so the TPU kernel's pad to whole tiles and its crop, two copies
that exist for its block shapes, are not done: the kernel masks the
ragged tail itself.  A CUDA tensor launches the kernel (each launch adds
one to ``stream_pipeline.launches``) or the call raises; a CPU tensor
takes the plain version after the chain is recorded, so a chain the
card cannot run fails on the CPU too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence

import torch

from repro_torch.backends.spec import UnsupportedBackendError
from repro_torch.device import NotPortedError
from repro_torch.kernels import build
from repro_torch.kernels.expr import (C_STORE, DTYPES, KINDS, RECORD_ERRORS,
                                      Expr, cast, count_ops, emit_c, record)
from repro_torch.kernels.launch import call_device, sm_count, stream_of

__all__ = ["PipelineKernel", "stream_pipeline", "stream_pipeline_staged",
           "stream_pipeline_ref", "unroll", "HEAVY_COST"]

#: threads of a block (csrc/stream_pipeline.cuh's kThreads)
_THREADS = 256
#: rough instructions an element of one recorded operation, without fast
#: math: the accurate transcendentals a few tens, IEEE sqrt and division
#: about ten, the rest one
_COST = {"tanh": 16, "exp": 16, "log": 16, "sin": 16, "cos": 16, "pow": 16,
         "sqrt": 8, "div": 8}
#: A chain that costs more than this an element is heavy.  Measured
#: (PERF.md): C4, ``tanh, *2, abs, sqrt`` (cost 26), streams like one
#: ``tanh``; C8, that chain twice (52), loses 12 % at 1080x1920 with the
#: light chains' 4 float4 a thread and runs best with every warp.
HEAVY_COST = 32


def unroll(cost: int, n: int, n_sm: int, l2_bytes: int,
           itemsize: int = 4) -> int:
    """The 16-byte packs a thread takes (1, 2 or 4) for a chain of
    ``cost`` over n values of ``itemsize`` bytes on a card of ``n_sm``
    SMs and an L2 of ``l2_bytes``.  A heavy chain takes 2 (two independent chains a
    thread) unless that leaves part of one wave of blocks empty, then 1.
    A light chain takes 2 when 4 would leave the wave half empty, 4
    while the plane fits in the L2, 1 past it.  Each choice was the
    fastest, or within 1 % of it, at every chain (1-16 stages) and plane
    (1080x1920 to 4320x7680) timed in ``tools/pipeline_variants.py``
    (PERF.md) on float32 planes; between those planes, and for the
    narrower types, the bands' edges are not measured.
    """
    wave = n_sm * 2048 // _THREADS          # blocks resident at once
    per_pack = 16 // itemsize

    def blocks(u: int) -> int:
        return -(-n // (per_pack * _THREADS * u))
    if cost > HEAVY_COST:
        return 1 if blocks(2) < wave else 2
    if blocks(4) < wave:
        return 2
    return 4 if itemsize * n <= l2_bytes else 1


class PipelineKernel:
    """One chain's generated CUDA source and its launcher, for planes of
    ``dtype`` (a type of :data:`~repro_torch.kernels.expr.KINDS`).

    Construction records each stage once on one input of the plane's
    type and emits the source; it needs no card and no nvcc.  A stage's
    value keeps its type into the next stage (a comparison's bool stays
    bool, so ``~v`` or ``v & w`` may follow it); the chain's final value
    is converted to ``out_dtype``, the plane's type by default.  A stage the recorder cannot
    express raises
    :class:`~repro_torch.backends.spec.UnsupportedBackendError` naming
    its index.  The library is built at the first launch.
    """

    def __init__(self, fns: Sequence[Callable],
                 dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype | None = None):
        self.fns = tuple(fns)
        self.dtype = dtype
        v = Expr("in", (0, 0, 0), KINDS[dtype])
        for i, fn in enumerate(self.fns):
            try:
                v = record(fn, [v])
            except RECORD_ERRORS as e:
                raise UnsupportedBackendError(
                    f"stage {i} of the chain ({fn!r}) cannot be recorded "
                    f"for the pipeline kernel ({type(e).__name__}: {e})",
                    backend="cuda_pipeline",
                    missing=(f"recordable:stage{i}",)) from e
        self.out_dtype = dtype if out_dtype is None else out_dtype
        self.expr = cast(v, KINDS[self.out_dtype])
        self.source = self._generate()
        self._fn = None
        self._lib = None

    def ops_per_element(self) -> int:
        """Arithmetic operations per plane element over the chain."""
        return count_ops(self.expr)

    def cost_per_element(self) -> int:
        """Rough instructions per plane element over the chain."""
        return count_ops(self.expr, _COST)

    def _generate(self) -> str:
        body, result = emit_c(self.expr, lambda k, dy, dx: "sg::widen(x)")
        name = str(self.dtype).removeprefix("torch.")
        out = str(self.out_dtype).removeprefix("torch.")
        return "\n".join([
            f"// Generated fused pointwise chain of {len(self.fns)} stages, "
            f"{name} -> {out}",
            '#include "stream_pipeline.cuh"',
            "",
            "namespace {",
            "struct Chain {",
            f"  using T = {C_STORE[KINDS[self.dtype]]};",
            f"  using U = {C_STORE[KINDS[self.out_dtype]]};",
            "  __device__ __forceinline__ U operator()(const T x) const {",
            *[f"    {ln}" for ln in body],
            f"    return sg::narrow<U>({result});",
            "  }",
            "};",
            "}  // namespace",
            "",
            'extern "C" int sp_launch(const void* in, void* out, long long n,'
            " int vec, int unroll, void* stream) {",
            "  return sp::launch<Chain>(in, out, n, vec, unroll, stream);",
            "}",
            "",
            'extern "C" const char* sp_error_string(int e) {',
            "  return cudaGetErrorString((cudaError_t)e);",
            "}",
            "",
        ])

    def launcher(self):
        """The library's ``sp_launch``, built and loaded on first use."""
        if self._fn is None:
            lib = build.load_library("sp", self.source)
            fn = lib.sp_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.sp_error_string.argtypes = [ctypes.c_int]
            lib.sp_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, x: torch.Tensor, unroll: int) -> torch.Tensor:
        """Run the chain over the contiguous CUDA tensor ``x`` of the
        kernel's type on the current stream, ``unroll`` (1, 2 or 4)
        16-byte steps a thread; returns a new tensor of its shape and
        the kernel's output type."""
        if (x.dtype != self.dtype or not x.is_contiguous()
                or x.device.type != "cuda"):
            raise ValueError(f"stream_pipeline launch: expected a contiguous "
                             f"{self.dtype} CUDA tensor, got {x.dtype} on "
                             f"{x.device} contiguous={x.is_contiguous()}")
        out = torch.empty_like(x, dtype=self.out_dtype)
        n = x.numel()
        vec = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        fn = self.launcher()
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), out.data_ptr(), n, int(vec), unroll,
                    stream_of(x.device))
        if rc != 0:
            msg = self._lib.sp_error_string(rc).decode()
            raise RuntimeError(f"stream_pipeline launch failed ({rc}): "
                               f"{msg}")
        return out


@functools.lru_cache(maxsize=256)
def _kernel(fns: tuple[Callable, ...], dtype: torch.dtype,
            out_dtype: torch.dtype | None) -> PipelineKernel:
    """The memo: each chain is recorded and loaded once per pair of
    types, not per call."""
    return PipelineKernel(fns, dtype, out_dtype)


def _checked(x: torch.Tensor, fns: Sequence[Callable]
             ) -> tuple[torch.Tensor, PipelineKernel]:
    """x made contiguous and the chain's kernel, or the typed error."""
    if x.dim() != 2:
        raise ValueError(f"stream_pipeline: x must be 2-D (H, W), got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in KINDS:
        raise NotPortedError(
            f"stream_pipeline: x is {x.dtype}; the kernel streams float32, "
            f"bfloat16, float16, int32 and bool planes.  The reference has "
            f"no 64-bit kernel either: under JAX's default "
            f"jax_enable_x64=False its float64 plane becomes float32 before "
            f"the kernel runs")
    call_device("stream_pipeline", x)
    return x.contiguous(), _kernel(tuple(fns), x.dtype, x.dtype)


def _run(kernel: PipelineKernel, x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return torch.empty_like(x)
    i = x.device.index or 0
    u = unroll(kernel.cost_per_element(), x.numel(), sm_count(i),
               torch.cuda.get_device_properties(i).L2_cache_size,
               x.element_size())
    out = kernel.launch(x, u)
    stream_pipeline.launches += 1
    return out


def stream_pipeline(x: torch.Tensor, fns: Sequence[Callable],
                    tile: tuple[int, int] = (256, 512)) -> torch.Tensor:
    """Fused execution of a pointwise stage chain over x: (H, W) of
    float32, bfloat16, float16, int32 or bool; the result has x's type.

    Each fn maps a tensor to a tensor elementwise with the operations
    :mod:`repro_torch.kernels.expr` records (arithmetic, comparisons,
    logic, casts, ``torch.sqrt/exp/log/abs/tanh/sin/cos/sign``,
    ``maximum/minimum/clamp/where``).  A non-contiguous x is made
    contiguous first.  ``tile`` is checked and kept for the reference's
    signature only: on the card the launch shape is the card's own (a
    grid sized from the flat plane), and the result of a pointwise chain
    does not depend on it.  There is no ``interpret`` keyword: a
    CPU tensor takes the plain version.
    """
    if (len(tile) != 2 or not all(isinstance(t, int) and t > 0
                                  for t in tile)):
        raise ValueError(f"stream_pipeline: tile must be two positive "
                         f"ints, got {tile!r}")
    x, kernel = _checked(x, fns)
    if x.device.type == "cpu":
        return stream_pipeline_ref(x, kernel.fns)
    return _run(kernel, x)


stream_pipeline.launches = 0


def stream_pipeline_staged(x: torch.Tensor, fns: Sequence[Callable]
                           ) -> torch.Tensor:
    """The baseline without dataflow: each stage materializes to device
    memory.  On the card the kernel runs once per stage, as a chain of
    one: one read and one write of the plane per stage, each launch
    counted in ``stream_pipeline.launches``; a stage's value keeps its
    type in memory (a comparison's as bool), the last is x's type.  Fused and staged runs then
    differ only in those round trips (an eager torch chain would launch
    once per torch op, not per stage).  A CPU tensor takes the plain
    version after every stage is recorded."""
    x, chain = _checked(x, fns)       # errors name the stage's index
    if x.device.type == "cpu":
        return stream_pipeline_ref(x, chain.fns)
    v = x
    for i, fn in enumerate(chain.fns):
        out = (x.dtype if i == len(chain.fns) - 1 else
               DTYPES[record(fn, [Expr("in", (0, 0, 0), KINDS[v.dtype])]).kind])
        v = _run(_kernel((fn,), v.dtype, out), v)
    return v


def stream_pipeline_ref(x: torch.Tensor, fns: Sequence[Callable]
                        ) -> torch.Tensor:
    """Plain PyTorch version: the chain over the whole tensor, then
    converted to x's type."""
    v = x
    for fn in fns:
        v = fn(v)
    return v.to(x.dtype)
