"""Fused RMSNorm -> SwiGLU MLP: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``fused_mlp`` / ``_kernel``
(``src/repro/kernels/fused_mlp.py``) with a hand-written CUDA kernel,
``csrc/fused_mlp.cu``: the normalized rows (float32, as in the TPU
kernel), ``silu(xn @ Wg) * (xn @ Wu)`` in 64-wide d_ff steps, and the
down projection accumulated per block, so the (T, d_ff) activation never
reaches device memory.

The TPU grid walks d_ff in order inside each row block.  Carried over, a
decode step's few rows would run on one thread block, so the port splits
d_ff across blocks as well: each (row tile, split) block writes a float32
partial (rows, d), and a second kernel adds the partials in split order
and casts.  No atomics, so the result does not depend on timing.  The
two launches are one call of :func:`fused_mlp` and count as ONE launch
in ``fused_mlp.launches``.  :func:`plan` picks the row tile and the
split so that one wave of blocks fills the card.

What bounds it: the weights' bytes at decode (3 * d * d_ff elements),
the float32 arithmetic at prefill lengths.  For CPU tensors the call
runs :func:`~repro_torch.kernels.ref.fused_mlp_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (call_device, dtype_code, sm_count,
                                        stream_of)
from repro_torch.kernels.ref import fused_mlp_ref

__all__ = ["fused_mlp", "MlpPlan", "plan", "BLOCK_F", "SMEM_LIMIT"]

#: d_ff columns per step of a block (csrc/fused_mlp.cu's BF)
BLOCK_F = 64
#: d rows of Wg / Wu staged at a time (csrc/fused_mlp.cu's DK)
_DK = 64
#: rows per block the kernel is built for
ROW_TILES = (4, 8, 16)
#: shared memory a block may use on Hopper, bytes
SMEM_LIMIT = 232448

_SOURCE = build.CudaSource("fused_mlp")
_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """How one call is cut: ``block_t`` rows per block, ``nsplit`` d_ff
    splits of ``steps_per_split`` 64-wide steps each."""
    block_t: int
    nsplit: int
    steps_per_split: int


def smem_bytes(block_t: int, d: int) -> int:
    """Shared memory of one block (csrc/fused_mlp.cu's smem_floats)."""
    return 4 * (block_t * d + block_t * _DK + 2 * _DK * BLOCK_F
                + block_t * BLOCK_F + block_t)


def plan(T: int, d: int, f: int, n_sm: int) -> MlpPlan:
    """The smallest row tile that holds T rows (else the largest that
    fits shared memory), and as many d_ff splits as fill one wave of
    ``n_sm`` blocks with the row tiles."""
    fits = [bt for bt in ROW_TILES if smem_bytes(bt, d) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"fused_mlp: d = {d} does not fit shared memory")
    block_t = next((bt for bt in fits if bt >= T), fits[-1])
    row_tiles = -(-T // block_t)
    steps = -(-f // BLOCK_F)
    nsplit = max(1, min(steps, n_sm // row_tiles))
    per = -(-steps // nsplit)
    return MlpPlan(block_t, -(-steps // per), per)


def fused_mlp(x: torch.Tensor, w_norm: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """x: (T, d); w_norm: (d,); w_gate/w_up: (d, f); w_down: (f, d) ->
    (T, d) in x's type.  The kernel on the card, the plain version on
    the CPU."""
    dev = call_device("fused_mlp", x, w_norm, w_gate, w_up, w_down)
    if dev.type == "cpu":
        return fused_mlp_ref(x, w_norm, w_gate, w_up, w_down, eps=eps)
    out = _launch(x, w_norm, w_gate, w_up, w_down, eps)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def _launch(x, w_norm, w_gate, w_up, w_down, eps) -> torch.Tensor:
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
    code = dtype_code("fused_mlp", "x", x)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(T, d, f, sm_count(x.device.index or 0))
    partial = torch.empty((p.nsplit, T, d), dtype=torch.float32,
                          device=x.device)
    fn = _SOURCE.function("fused_mlp_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_norm.data_ptr(), w_gate.data_ptr(),
                w_up.data_ptr(), w_down.data_ptr(), partial.data_ptr(),
                out.data_ptr(), code, T, d, f, float(eps), p.block_t,
                p.nsplit, p.steps_per_split, stream_of(x.device))
    _SOURCE.check(rc)
    return out
