"""Flash (streaming) attention: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``flash_attention`` / ``_kernel``
(``src/repro/kernels/flash_attention.py``) with a hand-written CUDA
kernel, ``csrc/flash_attention.cu``: GQA attention with an online
softmax over 64-key tiles, so the (Sq, Sk) logits never reach device
memory.  The kernel takes strided q/k/v (the last dim contiguous), so
the model's head-major views need no copy.

Unlike the TPU kernel, its causal mask is offset by ``Sk - Sq`` (the
oracle's, :func:`~repro_torch.kernels.ref.flash_attention_ref`) and pad
keys are masked in the kernel, so it is right at every length; the TPU
kernel offsets by the padded lengths and is wrong when they differ from
``Sk - Sq`` (S = 100, ROADMAP §C).  A row whose keys are all masked
gives 0, as the TPU kernel's does (the oracle gives NaN there).

What bounds it on the card: at the serving path's shapes (one prompt,
32 query heads, S <= 512, D = 64) the bytes (q, k, v read once, out
written once) bound it below a microsecond, so launch latency sets its
floor.  :func:`flash_attention` launches the kernel for CUDA tensors,
adding one to ``flash_attention.launches``, and runs the plain version
for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, dtype_code, stream_of
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "MAX_HEAD_DIM"]

#: the largest Dk or Dv the kernel takes
MAX_HEAD_DIM = 256

_SOURCE = build.CudaSource("flash_attention")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv);
    bias: (B, Sk) additive.  Returns (B, Hq, Sq, Dv) in q's type.

    The kernel on the card, the plain version on the CPU.
    """
    dev = call_device("flash_attention", q, k, v, bias)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, bias=bias, causal=causal,
                                   scale=scale)
    out = _launch(q, k, v, bias, causal, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _launch(q, k, v, bias, causal, scale) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    B, Hq, Sq, Dk = q.shape
    _, Hkv, Sk, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if max(Dk, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {max(Dk, Dv)} > "
                         f"{MAX_HEAD_DIM}")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} > 65535")
    if k.dtype != v.dtype:
        raise ValueError(f"flash_attention: k is {k.dtype}, v is {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous")
    q_code = dtype_code("flash_attention", "q", q)
    kv_code = dtype_code("flash_attention", "k", k)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if bias is not None:
        if tuple(bias.shape) != (B, Sk):
            raise ValueError(f"flash_attention: bias must be ({B}, {Sk}), "
                             f"got {tuple(bias.shape)}")
        bias = bias.to(torch.float32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    dims = (ctypes.c_int * 8)(B, Hq, Hkv, Sq, Sk, Dk, Dv, int(causal))
    strides = (ctypes.c_longlong * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        Sk if bias is None else bias.stride(0))
    fn = _SOURCE.function("flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                q_code, kv_code, dims, strides, float(scale),
                stream_of(q.device))
    _SOURCE.check(rc)
    return out
