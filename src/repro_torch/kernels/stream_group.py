"""The fused group kernel: generation, launch, and its plain version.

Replaces the TPU kernel ``lower_group_pallas`` / ``_group_kernel``
(``src/repro/core/fusion.py``) with one CUDA kernel per fusion group,
generated from the group and built by :mod:`repro_torch.kernels.build`.
The kernel's fixed part is hand-written in ``csrc/stream_group.cuh``
(halo-window loads, masked region evaluation, stores); per group,
:class:`GroupKernel` emits only the channel layout in shared memory and
each stage's body, recorded by :mod:`repro_torch.kernels.expr`.

What bounds it on the card: the bytes for most groups (each input read
once plus halo re-reads, each output written once; intermediates never
leave shared memory), the arithmetic for ``bilateral_filter``'s 25
``expf`` per pixel.  See the header for the block structure.

:func:`stream_group` launches the kernel for CUDA tensors and counts
each launch in ``stream_group.launches``; for CPU tensors it runs
:func:`stream_group_ref`, the stages composed whole-plane with
zero-padded patches.  A CUDA tensor never takes the plain path: the
kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.backends.spec import UnsupportedBackendError
from repro_torch.core.fusion import lower_group_torch
from repro_torch.core.graph import Channel, GraphError, Stage, as_dtype
from repro_torch.core.schedule import FusionGroup
from repro_torch.kernels import build
from repro_torch.kernels.expr import (RECORD_ERRORS, Expr, Patches,
                                      count_ops, emit_c, record)

__all__ = ["GroupKernel", "stream_group", "stream_group_ref"]


def stream_group_ref(group: FusionGroup, inputs: Sequence[torch.Tensor],
                     valid_rows: tuple[int, int] | None = None
                     ) -> list[torch.Tensor]:
    """Plain PyTorch version of the group kernel.

    ``inputs`` follow ``group.inputs``; the result follows
    ``group.outputs``.  Every stage runs over the whole plane as torch
    ops (the ``torch`` backend's lowering); stencils read zero-padded
    patches, and with ``valid_rows`` every stage output is zeroed
    outside the row band.
    """
    outs = lower_group_torch(group, valid_rows=valid_rows)(
        dict(zip(group.inputs, inputs)))
    return [outs[c] for c in group.outputs]


def stream_group(kernel: "GroupKernel", inputs: Sequence[torch.Tensor],
                 valid_rows: tuple[int, int] | None = None
                 ) -> list[torch.Tensor]:
    """Run one fusion group: the CUDA kernel on the card, the plain
    version on the CPU.  Each kernel launch adds one to
    ``stream_group.launches``."""
    devices = {x.device for x in inputs}
    if len(devices) != 1:
        raise ValueError(f"stream_group inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return stream_group_ref(kernel.group, inputs, valid_rows)
    if dev.type != "cuda":
        raise ValueError(f"stream_group runs on cuda or cpu, not {dev}")
    outs = kernel.launch(inputs, valid_rows)
    stream_group.launches += 1
    return outs


stream_group.launches = 0


class GroupKernel:
    """One fusion group's generated CUDA source and its launcher.

    Construction records every stage body and emits the source; it
    needs no card and no nvcc.  A stage the recorder cannot express,
    or a channel that is not float32, raises
    :class:`~repro_torch.backends.spec.UnsupportedBackendError` naming
    it.  The library is built at the first launch.
    """

    def __init__(self, group: FusionGroup):
        if group.is_trivial:
            raise GraphError("cannot generate a kernel for a custom/reduce "
                             "group")
        if group.tile is None:
            raise GraphError("the group has no tile; schedule it first")
        for ch in group.inputs + group.outputs + group.internal:
            if as_dtype(ch.dtype) != torch.float32:
                raise UnsupportedBackendError(
                    f"channel {ch.name!r} is {as_dtype(ch.dtype)}; the "
                    f"group kernel streams float32 planes only",
                    backend="cuda_stream", missing=("dtype:float32",))
        self.group = group
        self.plane: tuple[int, int] = tuple(group.stages[0].outputs[0].shape)
        self.tile: tuple[int, int] = tuple(group.tile)
        self.exprs: dict[int, Expr] = {
            id(st): _record_stage(st) for st in group.stages
            if st.kind != "split"}
        self.smem_bytes = group.smem_bytes(self.tile)
        self.source = self._generate()
        self._fn = None
        self._lib = None

    # ------------------------------------------------------------------
    def ops_per_element(self) -> int:
        """Arithmetic operations per plane element over all stages."""
        return sum(count_ops(e) for e in self.exprs.values())

    def _generate(self) -> str:
        g = self.group
        H, W = self.plane
        TH, TW = self.tile
        buffers: dict[Channel, tuple[str, int, int]] = {}
        lines = ["extern __shared__ float smem[];"]
        offset = 0
        for i, ch in enumerate(g.buffered_channels()):
            hy, hx = g.halo.get(ch, (0, 0))
            name = f"c{i}"
            buffers[ch] = (name, hy, hx)
            lines.append(f"float* const {name} = smem + {offset};"
                         f"  // {ch.name} halo=({hy},{hx})")
            offset += (TH + 2 * hy) * (TW + 2 * hx)
        lines.append("const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;")
        for k, ch in enumerate(g.inputs):
            name, hy, hx = buffers[ch]
            lines.append(f"sg::load_window<H, W, TH, TW, {hy}, {hx}>"
                         f"({name}, in{k}, y0, x0);")
        lines.append("__syncthreads();")
        outs = {ch: f"out{j}" for j, ch in enumerate(g.outputs)}

        def reader(ch: Channel, dy: int, dx: int) -> str:
            root = ch            # a split arm reads its source's window
            while root.producer is not None and root.producer.kind == "split" \
                    and root.producer in g.stages:
                root = root.producer.inputs[0]
            name, hy, hx = buffers[root]
            v = (f"{name}[(ly + {dy + hy}) * {TW + 2 * hx} + "
                 f"(lx + {dx + hx})]")
            if root is not ch and root in g.inputs:
                v = f"sg::row_masked({v}, y0 + ly + {dy}, r0, r1)"
            return v

        for st in g.stages:
            if st.kind == "split":
                continue
            out = st.outputs[0]
            body, result = emit_c(
                self.exprs[id(st)],
                lambda k, dy, dx, st=st: reader(st.inputs[k], dy, dx))
            lines.append(f"// stage {st.name!r} ({st.kind}, window "
                         f"{st.window[0]}x{st.window[1]})")
            if g.is_direct(out):
                head = (f"sg::eval_store<H, W, TH, TW>({outs[out]}, y0, x0, "
                        f"r0, r1, [&](int ly, int lx) {{")
            else:
                name, hy, hx = buffers[out]
                head = (f"sg::eval_region<W, TH, TW, {hy}, {hx}>({name}, y0,"
                        f" x0, r0, r1, [&](int ly, int lx) {{")
            lines.append(head)
            lines.extend(f"  {b}" for b in body)
            lines.append(f"  return {result};")
            lines.append("});")
            if not g.is_direct(out):
                lines.append("__syncthreads();")
        for ch in g.outputs:
            if g.is_direct(ch):
                continue
            lines.append(f"sg::eval_store<H, W, TH, TW>({outs[ch]}, y0, x0, "
                         f"r0, r1, [&](int ly, int lx) {{ return "
                         f"{reader(ch, 0, 0)}; }});")
        n_in, n_out = len(g.inputs), len(g.outputs)
        params = ([f"const float* __restrict__ in{k}" for k in range(n_in)]
                  + [f"float* __restrict__ out{j}" for j in range(n_out)]
                  + ["int r0", "int r1"])
        c_params = ([f"const void* in{k}" for k in range(n_in)]
                    + [f"void* out{j}" for j in range(n_out)]
                    + ["int r0", "int r1", "void* stream"])
        args = ([f"(const float*)in{k}" for k in range(n_in)]
                + [f"(float*)out{j}" for j in range(n_out)] + ["r0", "r1"])
        stages = ", ".join(s.name for s in g.stages)
        return "\n".join([
            f"// Generated fused group kernel: {stages}",
            f"// plane {H}x{W}, tile {TH}x{TW}, shared memory "
            f"{self.smem_bytes} bytes",
            '#include "stream_group.cuh"',
            "",
            "namespace {",
            f"constexpr int H = {H}, W = {W}, TH = {TH}, TW = {TW};",
            f"constexpr int SMEM_BYTES = {self.smem_bytes};",
            "",
            f"__global__ void __launch_bounds__(sg::kThreads) "
            f"sg_kernel({', '.join(params)}) {{",
            *[f"  {ln}" for ln in lines],
            "}",
            "}  // namespace",
            "",
            f'extern "C" int sg_launch({", ".join(c_params)}) {{',
            "  if (SMEM_BYTES > 48 * 1024) {",
            "    const cudaError_t e = cudaFuncSetAttribute(sg_kernel, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);",
            "    if (e != cudaSuccess) return (int)e;",
            "  }",
            "  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);",
            "  sg_kernel<<<grid, sg::kThreads, SMEM_BYTES, "
            "(cudaStream_t)stream>>>(" + ", ".join(args) + ");",
            "  return (int)cudaGetLastError();",
            "}",
            "",
            'extern "C" const char* sg_error_string(int e) {',
            "  return cudaGetErrorString((cudaError_t)e);",
            "}",
            "",
        ])

    # ------------------------------------------------------------------
    def launcher(self):
        """The library's ``sg_launch``, built and loaded on first use."""
        if self._fn is None:
            lib = build.load_library("sg", self.source)
            n = len(self.group.inputs) + len(self.group.outputs)
            fn = lib.sg_launch
            fn.argtypes = ([ctypes.c_void_p] * n
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.sg_error_string.argtypes = [ctypes.c_int]
            lib.sg_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, inputs: Sequence[torch.Tensor],
               valid_rows: tuple[int, int] | None) -> list[torch.Tensor]:
        """Launch on the inputs' card; returns the new output planes."""
        H, W = self.plane
        for x, ch in zip(inputs, self.group.inputs, strict=True):
            if (x.dtype != torch.float32 or tuple(x.shape) != (H, W)
                    or not x.is_contiguous()):
                raise ValueError(
                    f"stream_group input {ch.name!r}: expected a contiguous "
                    f"float32 ({H}, {W}) tensor, got {x.dtype} "
                    f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
        r0, r1 = valid_rows if valid_rows is not None else (0, H)
        dev = inputs[0].device
        outs = [torch.empty((H, W), dtype=torch.float32, device=dev)
                for _ in self.group.outputs]
        fn = self.launcher()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*[x.data_ptr() for x in inputs],
                    *[o.data_ptr() for o in outs], int(r0), int(r1), stream)
        if rc != 0:
            msg = self._lib.sg_error_string(rc).decode()
            raise RuntimeError(f"stream_group launch failed ({rc}): {msg}")
        return outs


def _record_stage(st: Stage) -> Expr:
    if st.kind == "stencil":
        args = [Patches(0, st.window)]
    elif st.kind in ("point", "pointN"):
        args = [Expr("in", (k, 0, 0), "f") for k in range(len(st.inputs))]
    else:
        raise UnsupportedBackendError(
            f"stage {st.name!r} of kind {st.kind!r} cannot stream",
            backend="cuda_stream", missing=(st.kind,))
    try:
        return record(st.fn, args)
    except RECORD_ERRORS as e:
        raise UnsupportedBackendError(
            f"stage {st.name!r}: its body cannot be recorded for the group "
            f"kernel ({type(e).__name__}: {e})", backend="cuda_stream",
            missing=("recordable:" + st.name,)) from e
