"""Flash (streaming) attention: the Hopper kernels and their wrapper.

Replaces the TPU kernel ``flash_attention`` / ``_kernel``
(``src/repro/kernels/flash_attention.py``) with hand-written CUDA
kernels, ``csrc/flash_attention.cu``: GQA attention with an online
softmax over 64-key tiles, so the (Sq, Sk) logits never reach device
memory.  The kernels take strided q/k/v (the last dim contiguous), so
the model's head-major views need no copy.

Two routes, chosen by :func:`route` from the operands' types and head
dims alone:

- ``"tc"``: bf16 q, k and v with Dk and Dv multiples of 16, Dk up to
  :data:`MAX_DK` (288) and Dv up to :data:`MAX_DV` (256): the serving
  path, MLA's absorbed prefill (Dk 288, Dv 256) included.  Tensor cores (``mma.sync`` m16n8k16, bf16 in,
  float32 accumulate), K and V tiles in flight by ``cp.async`` while
  the block computes, two key groups per block at Sk <= 512; the
  probabilities are rounded to bf16 for the PV product, the one
  rounding point the TPU kernel does not have.  Every row stride and
  pointer must be 16-byte aligned.
- ``"simt"``: everything else (float32 or mixed types, other head
  dims up to the same limits), float32 on the CUDA cores; it holds the float32 oracle to
  1e-5, which bf16 tensor cores cannot.

Unlike the TPU kernel, both offset the causal mask by ``Sk - Sq`` (the
oracle's, :func:`~repro_torch.kernels.ref.flash_attention_ref`) and
mask pad keys in the kernel, so they are right at every length; the
TPU kernel offsets by the padded lengths and is wrong when they differ
from ``Sk - Sq`` (S = 100, ROADMAP §C).  A row whose keys are all
masked gives 0, as the TPU kernel's does (the oracle gives NaN there).

What bounds it on the card: at the serving path's shapes (one prompt,
32 query heads, S <= 512, D = 64) the bytes (q, k, v read once, out
written once) bound it below a microsecond, so launch latency sets its
floor.  :func:`flash_attention` launches a kernel for CUDA tensors,
adding one to ``flash_attention.launches`` and to the route's own
count (``tc_launches`` or ``simt_launches``), and runs the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, dtype_code, stream_of
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "route", "MAX_DK", "MAX_DV"]

#: the largest Dk and Dv the kernels take (kv_lora_rank + rope_head_dim
#: and kv_lora_rank of MLA's absorbed prefill)
MAX_DK, MAX_DV = 288, 256

_SOURCE = build.CudaSource("flash_attention")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p])
_TC_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_float, ctypes.c_void_p])


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, dk: int,
          dv: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bf16 q,
    k and v with Dk and Dv multiples of 16, Dk <= :data:`MAX_DK` and
    Dv <= :data:`MAX_DV`, else ``"simt"`` (float32 on the CUDA cores)."""
    if (q_dtype == kv_dtype == torch.bfloat16 and dk % 16 == 0
            and dv % 16 == 0 and 0 < dk <= MAX_DK and 0 < dv <= MAX_DV):
        return "tc"
    return "simt"


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
    out, which = _launch(q, k, v, bias, causal, scale)
    if which is not None:                  # an empty output launches none
        flash_attention.launches += 1
        if which == "tc":
            flash_attention.tc_launches += 1
        else:
            flash_attention.simt_launches += 1
    return out


#: every launch, and each route's own
flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0


def _launch(q, k, v, bias, causal, scale) -> tuple[torch.Tensor, str | None]:
    """The output and the route launched (None: nothing to compute)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    B, Hq, Sq, Dk = q.shape
    _, Hkv, Sk, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if Dk > MAX_DK or Dv > MAX_DV:
        raise ValueError(f"flash_attention: head dims Dk {Dk}, Dv {Dv}; "
                         f"the kernels take Dk <= {MAX_DK}, Dv <= {MAX_DV}")
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
    which = route(q.dtype, k.dtype, Dk, Dv)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out, None
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if which == "tc":
            _check_aligned(q, k, v)
            fn = _SOURCE.function("flash_attention_tc_launch", _TC_ARGTYPES)
            rc = fn(*ptrs, dims, strides, float(scale), stream_of(q.device))
        else:
            fn = _SOURCE.function("flash_attention_launch", _ARGTYPES)
            rc = fn(*ptrs, q_code, kv_code, dims, strides, float(scale),
                    stream_of(q.device))
    _SOURCE.check(rc)
    return out, which


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core route copies rows by 16-byte ``cp.async``: every
    pointer and every stride but the last (of a dim longer than 1) must
    be 16-byte aligned."""
    for name, t in zip("qkv", tensors):
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % step for s, n in
                                    zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(
                f"flash_attention: {name} (data pointer {t.data_ptr()} mod "
                f"16 = {t.data_ptr() % 16}, strides {t.stride()}) is not "
                f"16-byte aligned; the tensor-core route needs it")
