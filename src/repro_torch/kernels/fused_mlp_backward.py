"""The fused MLP's backward for bf16 training: products on the tensor
cores, SwiGLU's backward in one hand-written kernel.

:class:`~repro_torch.kernels.autograd.FusedMlpFn` takes
:func:`fused_mlp_backward` when its saved inputs are bf16 (float32 and
float64 keep the plain recompute).  From the saved x, the four
weights and the output's gradient dy:

1. the norm again in float32, r = rsqrt(mean(x^2) + eps), h = x r w_norm,
   rounded to bf16 (``hb``) as the forward's tensor-core route rounds it;
2. eight products with bf16 operands and float32 sums and results
   (:func:`~repro_torch.kernels.launch.f32_matmul`): g = hb Wg,
   u = hb Wu, da = dy Wd^T; dWd = ab^T dy; dh = dg Wg^T + du Wu^T;
   dWg = hb^T dg, dWu = hb^T du;
3. between them :func:`swiglu_backward`, the kernel of
   ``csrc/fused_mlp_backward.cu``: ab = silu(g) u, dg and du, each
   rounded to bf16 once (ab as the forward rounds it);
4. the norm's backward in float32 over (T, d): dw_norm = sum_t dh x r,
   dx = r (dh w_norm - x r^2 mean(dh w_norm x)).

Each gradient is cast to its input's type.  Against the plain float32
backward the roundings are hb and ab (the forward has both) and dg and
du; dy and the bf16 weights are exact in bf16.  The products are plain
large matrix products outside any kernel, as the JAX package leaves its
``jax.grad`` products to XLA.  On the CPU the products upcast their
operands (a bf16 product is exact in float32, so only the order of the
sums differs) and SwiGLU's backward runs its plain version,
:func:`~repro_torch.kernels.ref.swiglu_backward_ref`, rounded to bf16.

What bounds a call: the products, 8 x 2 T d f operations (1.10 TFLOP at
granite's T = 4096, d 2048, f 8192: 1.11 ms at the bf16 peak).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (call_device, f32_matmul, sm_count,
                                       stream_of)
from repro_torch.kernels.ref import swiglu_backward_ref

__all__ = ["fused_mlp_backward", "swiglu_backward"]

_SOURCE = build.CudaSource("fused_mlp_backward")
_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def swiglu_backward(g: torch.Tensor, u: torch.Tensor,
                    da: torch.Tensor) -> tuple:
    """g, u, da: contiguous float32 tensors of one shape -> (ab, dg, du)
    in bf16 (``swiglu_backward_ref``, rounded).  The kernel on the card,
    the plain version on the CPU."""
    dev = call_device("swiglu_backward", g, u, da)
    for name, t in (("g", g), ("u", u), ("da", da)):
        if t.dtype != torch.float32 or t.shape != g.shape:
            raise ValueError(f"swiglu_backward: {name} must be float32 of "
                             f"shape {tuple(g.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if dev.type == "cpu":
        return tuple(t.to(torch.bfloat16)
                     for t in swiglu_backward_ref(g, u, da))
    if not (g.is_contiguous() and u.is_contiguous() and da.is_contiguous()):
        raise ValueError("swiglu_backward: g, u and da must be contiguous")
    outs = tuple(torch.empty(g.shape, dtype=torch.bfloat16, device=dev)
                 for _ in range(3))
    if g.numel() == 0:
        return outs
    fn = _SOURCE.function("fused_mlp_backward_swiglu", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(g.data_ptr(), u.data_ptr(), da.data_ptr(),
                *(t.data_ptr() for t in outs), g.numel(),
                sm_count(dev.index or 0), stream_of(dev))
    _SOURCE.check(rc)
    swiglu_backward.launches += 1
    return outs


#: every call that launched the kernel
swiglu_backward.launches = 0


def fused_mlp_backward(x, w_norm, w_gate, w_up, w_down, dy, eps: float,
                       want) -> tuple:
    """The gradients of ``fused_mlp(x, w_norm, w_gate, w_up, w_down,
    eps)`` for bf16 inputs, given the output's gradient ``dy``: (dx,
    dw_norm, dw_gate, dw_up, dw_down), None where ``want`` is False."""
    dy = dy.contiguous()        # a sum's gradient arrives with 0 strides
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wn = w_norm.float()
    hb = (xf * r * wn).to(x.dtype)
    ab, dg, du = swiglu_backward(f32_matmul(hb, w_gate),
                                 f32_matmul(hb, w_up),
                                 f32_matmul(dy, w_down.t()))
    dw_down = f32_matmul(ab.t(), dy).to(w_down.dtype) if want[4] else None
    del ab
    dw_gate = f32_matmul(hb.t(), dg).to(w_gate.dtype) if want[2] else None
    dw_up = f32_matmul(hb.t(), du).to(w_up.dtype) if want[3] else None
    dx = dw_norm = None
    if want[0] or want[1]:
        dh = f32_matmul(dg, w_gate.t())
        dh += f32_matmul(du, w_up.t())
        if want[1]:
            dw_norm = (dh * xf * r).sum(0).to(w_norm.dtype)
        if want[0]:
            dhw = dh * wn
            dx = (r * (dhw - xf * (r * r) * torch.mean(
                dhw * xf, dim=-1, keepdim=True))).to(x.dtype)
    return dx, dw_norm, dw_gate, dw_up, dw_down
