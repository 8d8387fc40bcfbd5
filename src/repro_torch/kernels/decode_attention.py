"""Decode (single-token) attention: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``decode_attention`` / ``_kernel``
(``src/repro/kernels/decode_attention.py``) with a hand-written CUDA
kernel, ``csrc/decode_attention.cu``: one query token per sequence
against an S-long KV cache, the ``G = Hq / Hkv`` query heads of a KV
head as the rows of one block, an online softmax over 128-key tiles,
and a (B, S) bias that carries each slot's length mask.

q and the cache may differ in type: the serving path's query is
bfloat16 and the batcher's cache float32.  The kernel converts each
operand to float32 as it loads it, so nothing is cast before the
launch; the output has q's type, as on the TPU.

What bounds it on the card: the cache's bytes, read once.  One block
per (sequence, KV head), the TPU's grid, leaves most of the 132 SMs
idle at a few slots; splitting S across blocks is the first redesign
(PERF.md).  :func:`decode_attention` launches the kernel for CUDA
tensors, adding one to ``decode_attention.launches``, and runs the
plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, dtype_code, stream_of
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "MAX_HEAD_DIM", "MAX_GROUP"]

#: the largest Dk or Dv the kernel takes
MAX_HEAD_DIM = 128
#: the most query heads per KV head
MAX_GROUP = 16

_SOURCE = build.CudaSource("decode_attention")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Dk); k: (B, Hkv, S, Dk); v: (B, Hkv, S, Dv); bias:
    (B, S) additive mask.  Returns (B, Hq, Dv) in q's type.

    The kernel on the card, the plain version on the CPU.
    """
    dev = call_device("decode_attention", q, k, v, bias)
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, bias=bias, scale=scale)
    out = _launch(q, k, v, bias, scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _launch(q, k, v, bias, scale) -> torch.Tensor:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q must be (B, Hq, D) and k, v "
                         "(B, Hkv, S, D)")
    B, Hq, Dk = q.shape
    _, Hkv, S, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if max(Dk, Dv) > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {max(Dk, Dv)} (max "
                         f"{MAX_HEAD_DIM}) or group {Hq // Hkv} (max "
                         f"{MAX_GROUP}) too large")
    if S == 0:
        raise ValueError("decode_attention: the cache is empty")
    if k.dtype != v.dtype:
        raise ValueError(f"decode_attention: k is {k.dtype}, v is {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name}'s last dim must be "
                             f"contiguous")
    q_code = dtype_code("decode_attention", "q", q)
    kv_code = dtype_code("decode_attention", "k", k)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if bias is not None:
        if tuple(bias.shape) != (B, S):
            raise ValueError(f"decode_attention: bias must be ({B}, {S}), "
                             f"got {tuple(bias.shape)}")
        bias = bias.to(torch.float32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    dims = (ctypes.c_int * 6)(B, Hq, Hkv, S, Dk, Dv)
    strides = (ctypes.c_longlong * 11)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        S if bias is None else bias.stride(0))
    fn = _SOURCE.function("decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                q_code, kv_code, dims, strides, float(scale),
                stream_of(q.device))
    _SOURCE.check(rc)
    return out
