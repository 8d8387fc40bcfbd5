"""Grouped SwiGLU experts over a dropless routing: the Hopper kernel and
its wrapper.

DeepSeek-V2 routes every token to its top-K experts with no capacity:
no choice is dropped, so an expert's row count depends on the data.  A
capacity route pads every expert to one size; at a decode step of 64
tokens over 64 experts that is hundreds of padded rows an expert for
about six real ones.  This route sorts the T K choices by expert on the
device (:func:`dispatch`: a stable sort, the experts' offsets by a
search of the sorted ids, each token's rows by the inverse permutation;
no host read and no shape that depends on the data), and
``csrc/moe_experts.cu`` runs each expert's SwiGLU over its own rows:
bf16 operands on the tensor cores with float32 sums, ``a`` rounded to
bf16 between the two halves (as the fused MLP's tensor-core route
does), each gate applied to its row's float32 output, and each token's
K rows added in ascending expert id, from zero.  No atomics, so a
captured step and an eager one give the same bits.

The grids depend on T alone: ``ceil(T / 16 mt)`` row tiles an expert
cover any routing (a token's K experts are distinct, so an expert has
at most T rows), and a tile with no rows returns before it reads a
weight.  :func:`plan` picks ``mt`` from the rows an expert expects, T K
/ E.  What bounds it: the experts' weights, read once per row tile.

:func:`moe_experts` launches the kernel for CUDA tensors (bf16, d and f
multiples of 8, 16-byte aligned), adding one to
``moe_experts.launches`` (a call is three launches), and runs
:func:`~repro_torch.kernels.ref.moe_experts_ref` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, stream_of
from repro_torch.kernels.ref import moe_experts_ref

__all__ = ["Dispatch", "dispatch", "moe_experts", "plan"]

_SOURCE = build.CudaSource("moe_experts")
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """The T K choices sorted by expert (stable: a token's order kept).

    ``rows`` (R,) int32: the token of each sorted choice; ``gates`` (R,)
    float32: its weight; ``offsets`` (E + 1,) int32: expert e's choices
    are rows ``offsets[e]:offsets[e + 1]``; ``slots`` (T, K) int32: each
    token's rows, ascending (so its experts in ascending id)."""
    rows: torch.Tensor
    gates: torch.Tensor
    offsets: torch.Tensor
    slots: torch.Tensor


def dispatch(experts: torch.Tensor, gates: torch.Tensor,
             n_experts: int) -> Dispatch:
    """The :class:`Dispatch` of ``experts`` (T, K), each token's K
    distinct chosen experts, weighted by ``gates`` (T, K).  On the
    device, with no host read: a CUDA graph can capture it."""
    T, K = experts.shape
    dev = experts.device
    flat = experts.reshape(-1)
    ids, order = torch.sort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, dtype=ids.dtype, device=dev)
    offsets = torch.searchsorted(ids, bounds).to(torch.int32)
    where = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, dtype=order.dtype, device=dev))
    return Dispatch(
        rows=torch.div(order, K, rounding_mode="floor").to(torch.int32),
        gates=gates.reshape(-1).to(torch.float32)[order],
        offsets=offsets,
        slots=where.view(T, K).sort(-1).values.to(torch.int32))


def plan(T: int, K: int, E: int) -> int:
    """Row tiles of 16 mt rows: the fewest (mt 1, 2 or 4) that hold the
    T K / E rows an expert expects."""
    expect = T * K / E
    return 1 if expect <= 16 else 2 if expect <= 32 else 4


def moe_experts(h: torch.Tensor, route: Dispatch, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """h: (T, d) normed tokens; ``route`` from :func:`dispatch`; w_gate /
    w_up (E, d, f), w_down (E, f, d).  Returns (T, d) float32: each
    token's gated expert outputs, summed.  The kernel on the card, the
    plain version on the CPU."""
    r = route
    dev = call_device("moe_experts", h, r.rows, r.gates, r.offsets, r.slots,
                      w_gate, w_up, w_down)
    if dev.type == "cpu":
        return moe_experts_ref(h, r.rows, r.offsets, r.gates, r.slots,
                               w_gate, w_up, w_down)
    _check(h, r, w_gate, w_up, w_down)
    T, d = h.shape
    E, _, f = w_gate.shape
    K = r.slots.shape[1]
    out = torch.empty((T, d), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    act = torch.empty((T * K, f), dtype=torch.bfloat16, device=dev)
    y = torch.empty((T * K, d), dtype=torch.float32, device=dev)
    fn = _SOURCE.function("moe_experts_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(h.data_ptr(), r.rows.data_ptr(), r.offsets.data_ptr(),
                r.gates.data_ptr(), r.slots.data_ptr(), w_gate.data_ptr(),
                w_up.data_ptr(), w_down.data_ptr(), act.data_ptr(),
                y.data_ptr(), out.data_ptr(), T, d, f, E, K, plan(T, K, E),
                stream_of(dev))
    _SOURCE.check(rc)
    moe_experts.launches += 1
    return out


#: every call that launched (three kernels a call)
moe_experts.launches = 0


def _check(h, r: Dispatch, w_gate, w_up, w_down) -> None:
    if h.dim() != 2:
        raise ValueError(f"moe_experts: h must be (T, d), got "
                         f"{tuple(h.shape)}")
    T, d = h.shape
    E, _, f = w_gate.shape
    K = r.slots.shape[-1]
    want = {"w_gate": ((E, d, f), torch.bfloat16),
            "w_up": ((E, d, f), torch.bfloat16),
            "w_down": ((E, f, d), torch.bfloat16),
            "h": ((T, d), torch.bfloat16),
            "rows": ((T * K,), torch.int32),
            "gates": ((T * K,), torch.float32),
            "offsets": ((E + 1,), torch.int32),
            "slots": ((T, K), torch.int32)}
    got = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down, "h": h,
           "rows": r.rows, "gates": r.gates, "offsets": r.offsets,
           "slots": r.slots}
    for name, t in got.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"moe_experts: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"moe_experts: {name} must be 16-byte aligned "
                             f"(the kernel's 16-byte copies)")
    if d % 8 or f % 8:
        raise ValueError(f"moe_experts: d ({d}) and f ({f}) must be "
                         f"multiples of 8")
    if not 1 <= K <= E:
        raise ValueError(f"moe_experts: {K} choices of {E} experts")
