"""The fused group kernel: generation, launch, and its plain version.

Replaces the TPU kernel ``lower_group_pallas`` / ``_group_kernel``
(``src/repro/core/fusion.py``) with one CUDA kernel per fusion group,
generated from the group and built by :mod:`repro_torch.kernels.build`.
The kernel's fixed part is hand-written in ``csrc/stream_group.cuh``
(halo-window copies, masked region evaluation, 16-byte loads and
stores); per group, :class:`GroupKernel` emits the channel layout, the
barriers and each stage's body, recorded by
:mod:`repro_torch.kernels.expr`: channels with a halo get a window in
shared memory, halo-free ones live in registers through one centre pass
of ``sg::kVec`` outputs a thread, a barrier goes only before a pass
that reads a window another thread wrote since the last one, and a
group with no window at all streams the plane flat.  A batch of ``B``
frames is one launch: ``gridDim.z = B``, each block on frame
``blockIdx.z`` (the port of the TPU kernel under the engine's
``jax.vmap``, which adds a batch axis to its grid).

What bounds it on the card: the bytes for most groups (each input read
once plus halo re-reads, each output written once; intermediates never
leave the chip), the arithmetic for ``bilateral_filter``'s 25 ``expf``
per pixel.  See the header for the block structure.

:func:`stream_group` launches the kernel for CUDA tensors and counts
each launch in ``stream_group.launches``; for CPU tensors it runs
:func:`stream_group_ref`, the stages composed whole-plane with
zero-padded patches.  A CUDA tensor never takes the plain path: the
kernel launches or the call raises.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from repro_torch.backends.spec import UnsupportedBackendError
from repro_torch.core.fusion import lower_group_torch
from repro_torch.core.graph import Channel, GraphError, Stage, as_dtype
from repro_torch.core.schedule import FusionGroup, pad4 as _pad4
from repro_torch.kernels import build
from repro_torch.kernels.expr import (RECORD_ERRORS, Expr, Patches,
                                      count_ops, emit_c, leaves, record)

__all__ = ["GroupKernel", "stream_group", "stream_group_ref"]

_VEC = 4            # adjacent outputs per thread and step: sg::kVec
_MAX_FRAMES = 65535  # gridDim.z: frames a launch


def stream_group_ref(group: FusionGroup, inputs: Sequence[torch.Tensor],
                     valid_rows: tuple[int, int] | None = None
                     ) -> list[torch.Tensor]:
    """Plain PyTorch version of the group kernel.

    ``inputs`` follow ``group.inputs``; the result follows
    ``group.outputs``.  Every stage runs over the whole plane as torch
    ops (the ``torch`` backend's lowering); stencils read zero-padded
    patches, and with ``valid_rows`` every stage output is zeroed
    outside the row band.  ``(B, H, W)`` inputs run frame by frame.
    """
    if inputs[0].dim() == 3:
        frames = [stream_group_ref(group, [x[b] for x in inputs], valid_rows)
                  for b in range(inputs[0].shape[0])]
        return [torch.stack(outs) for outs in zip(*frames)]
    outs = lower_group_torch(group, valid_rows=valid_rows)(
        dict(zip(group.inputs, inputs)))
    return [outs[c] for c in group.outputs]


def stream_group(kernel: "GroupKernel", inputs: Sequence[torch.Tensor],
                 valid_rows: tuple[int, int] | None = None
                 ) -> list[torch.Tensor]:
    """Run one fusion group on ``(H, W)`` planes or ``(B, H, W)``
    batches: the CUDA kernel on the card, the plain version on the CPU.
    Each kernel launch adds one to ``stream_group.launches``, whatever
    ``B`` is."""
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
    it.  The library is built at the first launch.  ``barriers`` counts
    the source's ``__syncthreads()``; ``flat`` says the group has no
    window and streams the plane flat (its tile is then unused).
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
        if TW % 4:
            raise GraphError(f"tile width {TW} is not a multiple of 4")
        windowed = g.buffered_channels()
        halo = collections.defaultdict(lambda: (0, 0), g.halo)
        lines: list[str] = []
        win: dict[Channel, str] = {}
        offset = 0
        if windowed:
            lines.append("extern __shared__ __align__(16) float smem[];")
        for i, ch in enumerate(windowed):
            hy, hx = halo[ch]
            win[ch] = f"c{i}"
            lines.append(f"float* const c{i} = smem + {offset};"
                         f"  // {ch.name} halo=({hy},{hx})")
            offset += (TH + 2 * hy) * (TW + 2 * _pad4(hx))
        if 4 * offset != self.smem_bytes:
            raise GraphError(f"window layout of {4 * offset} bytes != "
                             f"smem_bytes() {self.smem_bytes}")
        if win:
            lines.append("const int y0 = blockIdx.y * TH, "
                         "x0 = blockIdx.x * TW;")
        ins = {ch: f"in{k}" for k, ch in enumerate(g.inputs)}
        outs = {ch: f"out{j}" for j, ch in enumerate(g.outputs)}
        stages = [st for st in g.stages if st.kind != "split"]
        windowed_stages = [st for st in stages if st.outputs[0] in win]
        centre_stages = [st for st in stages if st.outputs[0] not in win]

        def root(ch: Channel) -> Channel:
            """A split arm reads its source's value."""
            while ch.producer is not None and ch.producer.kind == "split" \
                    and ch.producer in g.stages:
                ch = ch.producer.inputs[0]
            return ch

        def taps(st: Stage) -> list[tuple[Channel, int, int]]:
            return [(st.inputs[k], dy, dx)
                       for k, dy, dx in leaves(self.exprs[id(st)])]

        # -- windowed phase: barrier before a pass that reads a window
        # another thread wrote since the last barrier.  A region pass
        # writes element (ly, lx) of its window from the same thread as
        # any other region pass of the same halo, so a pointwise stage
        # reading such a window at (0, 0) needs none.
        dirty: dict[Channel, tuple[int, int] | None] = {}
        self.barriers = 0

        def barrier():
            if any(w is None for w in dirty.values()):
                lines.append("sg::load_wait();")    # this thread's copies
            lines.append("__syncthreads();")
            dirty.clear()
            self.barriers += 1

        for ch in g.inputs:
            if ch in win:
                hy, hx = halo[ch]
                lines.append(f"sg::load_window<VEC, H, W, TH, TW, {hy}, "
                             f"{hx}>({win[ch]}, {ins[ch]}, y0, x0);")
                dirty[ch] = None            # copied chunk by chunk

        def window_read(ch: Channel, dy: int, dx: int) -> str:
            r = root(ch)
            hy, hx = halo[r]
            px = _pad4(hx)
            v = (f"{win[r]}[(ly + {dy + hy}) * {TW + 2 * px} + "
                 f"(lx + {dx + px})]")
            if r is not ch and r in g.inputs:
                v = f"sg::row_masked({v}, y0 + ly + {dy}, r0, r1)"
            return v

        for st in windowed_stages:
            out = st.outputs[0]
            hy, hx = halo[out]
            if any(root(ch) in dirty and not (
                    dy == dx == 0 and dirty[root(ch)] == (hy, hx))
                   for ch, dy, dx in taps(st)):
                barrier()
            body, result = emit_c(
                self.exprs[id(st)],
                lambda k, dy, dx, st=st: window_read(st.inputs[k], dy, dx))
            lines.append(f"// stage {st.name!r} ({st.kind}, window "
                         f"{st.window[0]}x{st.window[1]}) over its halo")
            lines.append(f"sg::eval_region<W, TH, TW, {hy}, {hx}>("
                         f"{win[out]}, y0, x0, r0, r1, [&](int ly, int lx) {{")
            lines.extend(f"  {b}" for b in body)
            lines.append(f"  return {result};")
            lines.append("});")
            dirty[out] = (hy, hx)

        # -- centre pass: halo-free stages in registers, kVec outputs per
        # thread and step; window rows read once per step.
        reads = [t for st in centre_stages for t in taps(st)]
        reads += [(ch, 0, 0) for ch in g.outputs if not g.is_direct(ch)]
        margin: dict[tuple[Channel, int], int] = {}
        for ch, dy, dx in reads:
            r = root(ch)
            if r in win:
                margin[r, dy] = max(margin.get((r, dy), 0), _pad4(abs(dx)))
            elif (dy, dx) != (0, 0):
                raise GraphError(f"halo-free channel {r.name!r} read at "
                                 f"offset ({dy}, {dx})")
        if any(r in dirty for r, _ in margin):
            barrier()
        # A group without windows has no halo: it streams the plane flat,
        # each block a contiguous run of STEPS * kFlatThreads chunks of
        # kVec elements (a chunk may span two rows: row masks per element).
        # Otherwise a thread takes kVec adjacent outputs of a tile row.
        flat = not win
        if flat:
            threads = "sg::kFlatThreads"
            where = ["const int c = blockIdx.x * (STEPS * sg::kFlatThreads) "
                     "+ threadIdx.x + s * sg::kFlatThreads;"]
            bound = "if (c >= N4) break;"
            if H * W >= 2**31:
                raise GraphError(f"plane {H}x{W} has 2**31 elements or more")
            # a chunk lies in one row when W % kVec == 0
            row = ("(unsigned)(sg::kVec * c) / W" if W % _VEC == 0 else
                   "(unsigned)(sg::kVec * c + o) / W")
            body: list[str] = [
                "int gy[sg::kVec];",
                "bool row_ok[sg::kVec];",
                "#pragma unroll",
                "for (int o = 0; o < sg::kVec; ++o) {",
                f"  gy[o] = (int)({row});",
                "  row_ok[o] = gy[o] >= r0 && gy[o] < r1;",
                "}"]
            at = "c"
            lines.append("constexpr int N4 = (H * W + sg::kVec - 1) / "
                         "sg::kVec;  // chunks of the plane")
            lines.append("constexpr int STEPS = sg::kFlatSteps;")
        else:
            threads = "sg::kThreads"
            where = ["const int i = threadIdx.x + s * sg::kThreads;",
                     "if (i >= TH * (TW / sg::kVec)) break;",
                     "const int ly = i / (TW / sg::kVec), "
                     "lx = (i % (TW / sg::kVec)) * sg::kVec;",
                     "const int gy = y0 + ly, gx = x0 + lx;"]
            bound = ""
            body = ["const bool row_ok = gy >= r0 && gy < r1;"]
            at = "gy, gx"
            lines.append("constexpr int STEPS = (TH * (TW / sg::kVec) + "
                         "sg::kThreads - 1) / sg::kThreads;")
        suffix = "_flat" if flat else ""

        def row_ok(o: int) -> str:
            return f"row_ok[{o}]" if flat else "row_ok"

        def row_of(o: int, dy: int) -> str:
            return f"gy[{o}]" if flat else f"gy + {dy}"

        regs: dict[Channel, str] = {}
        rows: dict[tuple[Channel, int], str] = {}
        # halo-free group inputs: every step's elements are loaded before
        # the first step computes, so a thread has them all in flight
        direct = [ch for ch in g.inputs if ch not in win
                  and any(root(c) is ch for c, _, _ in reads)]
        for k, ch in enumerate(direct):
            regs[ch] = f"g{k}[s]"
        if direct:
            lines.extend(f"float g{k}[STEPS][sg::kVec];"
                         for k in range(len(direct)))
            lines.append("#pragma unroll")
            lines.append("for (int s = 0; s < STEPS; ++s) {")
            lines.extend(f"  {w}" for w in where)
            if bound:
                lines.append(f"  {bound}")
            lines.extend(f"  sg::load4{suffix}<VEC, H, W>(g{k}[s], "
                         f"{ins[ch]}, {at});" for k, ch in enumerate(direct))
            lines.append("}")

        def centre_read(ch: Channel, dy: int, dx: int, o: int) -> str:
            r = root(ch)
            if r in win:
                m = margin[r, dy]
                v = f"{rows[r, dy]}[{m + o + dx}]"
            else:
                v = f"{regs[r]}[{o}]"
            if r is not ch and r in g.inputs:
                v = f"sg::row_masked({v}, {row_of(o, dy)}, r0, r1)"
            return v

        def need_rows(chans: list[tuple[Channel, int, int]]) -> None:
            for ch, dy, _ in chans:
                r = root(ch)
                if r in win and (r, dy) not in rows:
                    name = f"w{len(rows)}"
                    rows[r, dy] = name
                    hy, hx = halo[r]
                    m = margin[r, dy]
                    body.append(f"float {name}[sg::kVec + {2 * m}];")
                    body.append(f"sg::window_row<TW, {hy}, {hx}, {m}>("
                                f"{name}, {win[r]}, ly{dy:+d}, lx);")

        def stored(ch: Channel, name: str) -> None:
            if ch in outs:
                body.append(f"sg::store4{suffix}<VEC, H, W>({outs[ch]}, "
                            f"{at}, {name});")

        for st in centre_stages:
            out = st.outputs[0]
            need_rows(taps(st))
            regs[out] = name = f"v{len(regs)}"
            body.append(f"// stage {st.name!r} ({st.kind}, window "
                        f"{st.window[0]}x{st.window[1]}) over the centre")
            body.append(f"float {name}[sg::kVec];")
            for o in range(_VEC):
                stmts, result = emit_c(
                    self.exprs[id(st)],
                    lambda k, dy, dx, st=st, o=o: centre_read(
                        st.inputs[k], dy, dx, o))
                body.append("{")
                body.extend(f"  {b}" for b in stmts)
                body.append(f"  {name}[{o}] = {row_ok(o)} ? {result} : 0.0f;")
                body.append("}")
            stored(out, name)
        for ch in g.outputs:
            if g.is_direct(ch):
                continue
            need_rows([(ch, 0, 0)])
            name = f"s{len(regs)}"
            regs[ch] = name
            body.append(f"float {name}[sg::kVec];  // output {ch.name}")
            for o in range(_VEC):
                body.append(f"{name}[{o}] = {row_ok(o)} ? "
                            f"{centre_read(ch, 0, 0, o)} : 0.0f;")
            stored(ch, name)
        if direct or flat:    # g*[s] stay in registers: unrolled steps
            lines.append("#pragma unroll")
            lines.append("for (int s = 0; s < STEPS; ++s) {")
            lines.extend(f"  {w}" for w in where)
            if bound:
                lines.append(f"  {bound}")
        else:
            lines.append("for (int i = threadIdx.x; i < TH * (TW / sg::kVec);"
                         " i += sg::kThreads) {")
            lines.extend(f"  {w}" for w in where[2:])
        lines.extend(f"  {b}" for b in body)
        lines.append("}")
        self.flat = flat

        n_in, n_out = len(g.inputs), len(g.outputs)
        # frame blockIdx.z of a (B, H, W) batch: the BATCH instance moves
        # every pointer to its frame first, in 64-bit arithmetic.  One
        # frame launches the instance without the offset, which alone
        # cost a single frame 3-6 % (tools/group_batch_cost.py).
        lines[:0] = ["if constexpr (BATCH) {",
                     "  const size_t frame = (size_t)blockIdx.z * "
                     "((size_t)H * W);",
                     *[f"  in{k} += frame;" for k in range(n_in)],
                     *[f"  out{j} += frame;" for j in range(n_out)],
                     "}"]
        params = ([f"const float* __restrict__ in{k}" for k in range(n_in)]
                  + [f"float* __restrict__ out{j}" for j in range(n_out)]
                  + ["int r0", "int r1"])
        c_params = ([f"const void* in{k}" for k in range(n_in)]
                    + [f"void* out{j}" for j in range(n_out)]
                    + ["int r0", "int r1", "int vec", "int B",
                       "void* stream"])
        args = ([f"(const float*)in{k}" for k in range(n_in)]
                + [f"(float*)out{j}" for j in range(n_out)] + ["r0", "r1"])
        # VEC: 16-byte loads and stores, where the wrapper found every
        # pointer aligned (vec) and every row (W % 4 == 0) or, flat, every
        # chunk starts 16-byte aligned
        variants = (["true", "false"] if W % 4 == 0 or flat else ["false"])

        def launch(variant: str, batch: bool) -> list[str]:
            kernel = f"sg_kernel<{variant}{', true' if batch else ''}>"
            return ["if (SMEM_BYTES > 48 * 1024) {",
                    f"  const cudaError_t e = cudaFuncSetAttribute("
                    f"{kernel}, "
                    f"cudaFuncAttributeMaxDynamicSharedMemorySize, "
                    f"SMEM_BYTES);",
                    "  if (e != cudaSuccess) return (int)e;",
                    "}",
                    f"{kernel}<<<grid, {threads}, "
                    f"SMEM_BYTES, (cudaStream_t)stream>>>("
                    + ", ".join(args) + ");"]

        def on_vec(batch: bool) -> list[str]:
            if len(variants) == 1:
                return ["{", *(f"  {ln}" for ln in launch("false", batch)),
                        "}"]
            return ["if (vec) {", *(f"  {ln}" for ln in launch("true", batch)),
                    "} else {", *(f"  {ln}" for ln in launch("false", batch)),
                    "}"]

        grid = ("((H * W + sg::kVec - 1) / sg::kVec + sg::kFlatSteps * "
                "sg::kFlatThreads - 1) / (sg::kFlatSteps * sg::kFlatThreads)"
                ", 1, B" if flat else
                "(W + TW - 1) / TW, (H + TH - 1) / TH, B")
        dispatch = ([] if len(variants) == 2 else
                    ["  (void)vec;  // W % 4 != 0: scalar loads and stores"])
        dispatch += ["  if (B > 1) {", *(f"    {ln}" for ln in on_vec(True)),
                     "  } else {  // one frame: no frame offset",
                     *(f"    {ln}" for ln in on_vec(False)), "  }"]
        names = ", ".join(s.name for s in g.stages)
        return "\n".join([
            f"// Generated fused group kernel: {names}",
            f"// plane {H}x{W}, tile {TH}x{TW}, shared memory "
            f"{self.smem_bytes} bytes, {self.barriers} barriers",
            '#include "stream_group.cuh"',
            "",
            "namespace {",
            f"constexpr int H = {H}, W = {W}, TH = {TH}, TW = {TW};",
            f"constexpr int SMEM_BYTES = {self.smem_bytes};",
            "",
            "template <bool VEC, bool BATCH = false>",
            f"__global__ void __launch_bounds__({threads}) "
            f"sg_kernel({', '.join(params)}) {{",
            *[f"  {ln}" for ln in lines],
            "}",
            "}  // namespace",
            "",
            f'extern "C" int sg_launch({", ".join(c_params)}) {{',
            f"  const dim3 grid({grid});",
            *dispatch,
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
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.sg_error_string.argtypes = [ctypes.c_int]
            lib.sg_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, inputs: Sequence[torch.Tensor],
               valid_rows: tuple[int, int] | None) -> list[torch.Tensor]:
        """Launch on the inputs' card; returns the new output planes.

        Each input is one contiguous float32 ``(H, W)`` plane or a
        contiguous ``(B, H, W)`` batch of them: one launch computes all
        ``B`` frames (``gridDim.z = B``), ``valid_rows`` applying to each.
        """
        H, W = self.plane
        lead = tuple(inputs[0].shape[:-2])
        for x, ch in zip(inputs, self.group.inputs, strict=True):
            if (x.dtype != torch.float32 or tuple(x.shape) != (*lead, H, W)
                    or len(lead) > 1 or not x.is_contiguous()):
                raise ValueError(
                    f"stream_group input {ch.name!r}: expected a contiguous "
                    f"float32 ({H}, {W}) or (B, {H}, {W}) tensor, all of one "
                    f"shape; got {x.dtype} {tuple(x.shape)} "
                    f"contiguous={x.is_contiguous()}")
        B = lead[0] if lead else 1
        if not 1 <= B <= _MAX_FRAMES:
            raise ValueError(f"stream_group takes 1 to {_MAX_FRAMES} frames "
                             f"a launch, got {B}")
        r0, r1 = valid_rows if valid_rows is not None else (0, H)
        dev = inputs[0].device
        outs = [torch.empty((*lead, H, W), dtype=torch.float32, device=dev)
                for _ in self.group.outputs]
        fn = self.launcher()
        ptrs = [t.data_ptr() for t in (*inputs, *outs)]
        # every frame's base is 16-byte aligned when the batch's is and
        # W % 4 == 0 (then H * W % 4 == 0 too)
        vec = int(W % 4 == 0 and all(p % 16 == 0 for p in ptrs))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*ptrs, int(r0), int(r1), vec, int(B), stream)
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
