"""Fused RMSNorm -> SwiGLU MLP: the Hopper kernels and their wrapper.

Replaces the TPU kernel ``fused_mlp`` / ``_kernel``
(``src/repro/kernels/fused_mlp.py``) with hand-written CUDA kernels,
``csrc/fused_mlp.cu``: the normalized rows, ``silu(xn @ Wg) * (xn @
Wu)`` and the down projection per block, so the (T, d_ff) activation
never reaches device memory.

The TPU grid walks d_ff in order inside each row block.  Carried over, a
decode step's few rows would run on one thread block, so the port splits
d_ff across blocks as well: each (row tile, split) block writes a float32
partial (rows, d), and a second kernel adds the partials in a fixed
order and casts.  No atomics, so the result does not depend on timing.
The launches of one call (the tensor-core route also normalizes first)
count as ONE launch in ``fused_mlp.launches`` and in the route's own
count.

Three routes, chosen by :func:`route` from the type, T and the shapes:

- ``"stream"``: bf16 with T <= :data:`STREAM_MAX_T` (decode).  Bound
  by the weights' bytes; the float32 arithmetic stays on the CUDA cores
  (a fifth of the byte time at T = 4), each block streaming a 64-column
  slice of d_ff with 16-byte loads, several in flight a thread.
- ``"tc"``: bf16 at prefill lengths.  Tensor cores (``mma.sync``
  m16n8k16, bf16 in, float32 accumulate) fed by a ``cp.async`` ring;
  xn and a are rounded to bf16 on the way in, the two rounding points
  the float32 plain version does not have.  :func:`tc_plan` trades the
  partials' bytes against blocks per wave.
- ``"simt"``: float32 (it holds the float32 plain version to 1e-5, which
  bf16 tensor cores cannot), and bf16 shapes the other routes refuse (d
  or d_ff not a multiple of 8, or an operand not 16-byte aligned):
  float32 FMAs on the CUDA cores, :func:`plan` cuts it.

What bounds it on the card: the weights' bytes (3 * d * d_ff bf16,
0.030 ms for granite) at every served T; the bf16 operations at T = 255
take less.  The decode route reaches about half of that bound; the
tensor-core route is held back by the stalls between its steps and by
the partials' bytes (``PERF.md``).  For CPU tensors the call runs
:func:`~repro_torch.kernels.ref.fused_mlp_ref`.

Training wraps the call in ``kernels/autograd.py``'s ``FusedMlpFn``,
whose backward follows the forward's type: bf16, the type of a bf16
model's weights and activations, takes
:mod:`~repro_torch.kernels.fused_mlp_backward` (tensor-core products
with float32 sums, SwiGLU's backward in ``csrc/fused_mlp_backward.cu``,
counted in ``fused_mlp.tc_backward_calls``); float32 and float64 take
the plain version's float32 (float64) recompute.  ``backward_calls``
counts both.  Neither backward adds to ``launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (call_device, dtype_code, sm_count,
                                        stream_of)
from repro_torch.kernels.ref import fused_mlp_ref

__all__ = ["fused_mlp", "route", "MlpPlan", "plan", "TcPlan", "tc_plan",
           "BLOCK_F", "SMEM_LIMIT", "STREAM_MAX_T"]

#: d_ff columns per step of a CUDA-core block (csrc/fused_mlp.cu's BF)
BLOCK_F = 64
#: d rows of Wg / Wu staged at a time (csrc/fused_mlp.cu's DK)
_DK = 64
#: rows per block the CUDA-core kernel is built for
ROW_TILES = (4, 8, 16)
#: shared memory a block may use on Hopper, bytes
SMEM_LIMIT = 232448
#: the largest T the decode route takes (its rows live in registers)
STREAM_MAX_T = 8
#: d_ff columns of a decode-route block (stream::FS)
_STREAM_FS = 64
#: tensor-core route: ring stages, tile depth and padded row strides
_TC_STAGES, _TC_BK, _TC_LDK = 3, 64, 72
#: the widest d_ff slice of a tensor-core block
_TC_MAX_FS = 512

_SOURCE = build.CudaSource("fused_mlp")
_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_STREAM_ARGTYPES = ([ctypes.c_void_p] * 7
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p])
_TC_ARGTYPES = ([ctypes.c_void_p] * 8
                + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """How a CUDA-core call is cut: ``block_t`` rows per block,
    ``nsplit`` d_ff splits of ``steps_per_split`` 64-wide steps each."""
    block_t: int
    nsplit: int
    steps_per_split: int


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """How a tensor-core call is cut: ``64 * mt`` rows per block and
    ``nsplit`` d_ff slices of ``fs`` columns each."""
    mt: int
    fs: int
    nsplit: int


def smem_bytes(block_t: int, d: int) -> int:
    """Shared memory of one CUDA-core block (csrc/fused_mlp.cu's
    smem_floats)."""
    return 4 * (block_t * d + block_t * _DK + 2 * _DK * BLOCK_F
                + block_t * BLOCK_F + block_t)


def stream_smem_bytes(tp: int, d: int) -> int:
    """Shared memory of one decode-route block for ``tp`` padded rows
    (stream::smem_bytes)."""
    return 4 * (d * tp + 8 * tp * 2 * _STREAM_FS + _STREAM_FS * tp)


def tc_smem_bytes(mt: int, fs: int, stages: int = _TC_STAGES) -> int:
    """Shared memory of one tensor-core block (tc::smem_bytes) with a
    ring of ``stages`` slots."""
    return 2 * (stages * (64 * mt + 2 * _TC_BK) * _TC_LDK
                + 64 * mt * (fs + 8))


def _stream_rows(T: int) -> int:
    """The decode route's padded row count for T rows: 1, 2, 4 or 8."""
    return 1 << max(0, (T - 1).bit_length())


def route(dtype: torch.dtype, T: int, d: int, f: int,
          aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"stream"`` for bf16 with T <=
    STREAM_MAX_T, ``"tc"`` for bf16 at larger T, both only when d and
    d_ff are multiples of 8 and every operand is 16-byte aligned; else
    ``"simt"``."""
    if (dtype != torch.bfloat16 or d % 8 or f % 8 or not aligned):
        return "simt"
    if (T <= STREAM_MAX_T
            and stream_smem_bytes(_stream_rows(T), d) <= SMEM_LIMIT):
        return "stream"
    return "tc"


def plan(T: int, d: int, f: int, n_sm: int) -> MlpPlan:
    """The CUDA-core route's cut: the smallest row tile that holds T rows
    (else the largest that fits shared memory), and as many d_ff splits
    as fill one wave of ``n_sm`` blocks with the row tiles."""
    fits = [bt for bt in ROW_TILES if smem_bytes(bt, d) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"fused_mlp: d = {d} does not fit shared memory")
    block_t = next((bt for bt in fits if bt >= T), fits[-1])
    row_tiles = -(-T // block_t)
    steps = -(-f // BLOCK_F)
    nsplit = max(1, min(steps, n_sm // row_tiles))
    per = -(-steps // nsplit)
    return MlpPlan(block_t, -(-steps // per), per)


def tc_plan(T: int, f: int, n_sm: int) -> TcPlan:
    """The tensor-core route's cut: 64-row tiles up to 128 rows, 128-row
    tiles past that (each weight tile then serves twice the rows), and
    the narrowest d_ff slice (a multiple of 64, at most 512, within
    shared memory) whose blocks fit one wave of ``n_sm`` blocks.
    Narrower slices mean more blocks, but more partials to write and
    add: nsplit * T * d * 8 bytes."""
    mt = 2 if T > 128 else 1
    row_tiles = -(-T // (64 * mt))
    fits = [c for c in range(64, _TC_MAX_FS + 1, 64)
            if tc_smem_bytes(mt, c) <= SMEM_LIMIT]
    fs = next((c for c in fits if row_tiles * -(-f // c) <= n_sm), fits[-1])
    return TcPlan(mt, fs, -(-f // fs))


def fused_mlp(x: torch.Tensor, w_norm: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """x: (T, d); w_norm: (d,); w_gate/w_up: (d, f); w_down: (f, d) ->
    (T, d) in x's type.  The kernel on the card, the plain version on
    the CPU."""
    dev = call_device("fused_mlp", x, w_norm, w_gate, w_up, w_down)
    if dev.type == "cpu":
        return fused_mlp_ref(x, w_norm, w_gate, w_up, w_down, eps=eps)
    _check(x, w_norm, w_gate, w_up, w_down)
    if x.numel() == 0:
        return torch.empty_like(x)
    which = route(x.dtype, x.shape[0], x.shape[1], w_gate.shape[1],
                  _aligned(x, w_norm, w_gate, w_up, w_down))
    out = launch_route(which, x, w_norm, w_gate, w_up, w_down, eps)
    fused_mlp.launches += 1
    setattr(fused_mlp, f"{which}_launches",
            getattr(fused_mlp, f"{which}_launches") + 1)
    return out


#: every call that launched, and each route's own
fused_mlp.launches = 0
fused_mlp.stream_launches = 0
fused_mlp.tc_launches = 0
fused_mlp.simt_launches = 0


def _check(x, w_norm, w_gate, w_up, w_down) -> None:
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    f = w_gate.shape[-1]
    want = {"w_norm": (d,), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}
    for name, t in (("x", x), ("w_norm", w_norm), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down)):
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"fused_mlp: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be a contiguous "
                             f"{x.dtype} tensor, got {t.dtype} contiguous="
                             f"{t.is_contiguous()}")
    dtype_code("fused_mlp", "x", x)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every pointer 16-byte aligned (the bf16 routes' 16-byte copies)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch_route(which: str, x, w_norm, w_gate, w_up, w_down,
                 eps) -> torch.Tensor:
    """Launches route ``which`` on checked CUDA operands (T >= 1) and
    returns the output; counts nothing."""
    T, d = x.shape
    f = w_gate.shape[1]
    dev = x.device
    n_sm = sm_count(dev.index or 0)
    out = torch.empty((T, d), dtype=x.dtype, device=dev)
    ptrs = (x.data_ptr(), w_norm.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr())
    if which == "stream":
        nsplit = -(-f // _STREAM_FS)
        partial = torch.empty((nsplit, T, d), dtype=torch.float32,
                              device=dev)
        fn = _SOURCE.function("fused_mlp_stream_launch", _STREAM_ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(*ptrs, partial.data_ptr(), out.data_ptr(), T, d, f,
                    float(eps), stream_of(dev))
    elif which == "tc":
        p = tc_plan(T, f, n_sm)
        xn = torch.empty((T, d), dtype=torch.bfloat16, device=dev)
        partial = torch.empty((p.nsplit, T, d), dtype=torch.float32,
                              device=dev)
        fn = _SOURCE.function("fused_mlp_tc_launch", _TC_ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(*ptrs, xn.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), T, d, f, float(eps), p.mt, p.fs,
                    stream_of(dev))
    elif which == "simt":
        p = plan(T, d, f, n_sm)
        partial = torch.empty((p.nsplit, T, d), dtype=torch.float32,
                              device=dev)
        fn = _SOURCE.function("fused_mlp_launch", _ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(*ptrs, partial.data_ptr(), out.data_ptr(),
                    dtype_code("fused_mlp", "x", x), T, d, f, float(eps),
                    p.block_t, p.nsplit, p.steps_per_split, stream_of(dev))
    else:
        raise ValueError(f"fused_mlp: no route {which!r}")
    _SOURCE.check(rc)
    return out
