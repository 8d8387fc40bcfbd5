"""Public wrappers of the LM kernels (the port of ``repro.kernels.ops``).

Every op takes ``impl=``:

- ``"cuda"`` — the hand-written Hopper kernel; a CPU tensor raises;
- ``"ref"``  — the plain PyTorch version (:mod:`repro_torch.kernels.ref`),
  on whatever device the tensors are;
- ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
  tensors, for every op, prefill attention included.

``"auto"`` departs from the reference for prefill attention: there
``models/layers.py`` resolves ``"auto"`` with ``auto_native=False``, so
prefill kept the portable XLA form and reached the Pallas kernel only
when asked by name, because that kernel is wrong at ragged causal
lengths (ROADMAP §C).  The port's kernel is right at every length, so
``"auto"`` takes it.  Models call only these wrappers, so the kernel
choice is a config knob (``ModelConfig.attn_impl``).

``ssd`` departs from the reference too: its Pallas route refuses
``init_state``; the port's kernel starts from it, on both routes.

Training: where the kernel runs, grad mode is on and some input
requires a gradient, ``attention``, ``mlp`` and ``ssd`` go through the
``torch.autograd.Function`` of :mod:`repro_torch.kernels.autograd`
(the kernel forward, the plain version's backward); every other call,
serving's included, launches the kernel as before.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceUnavailableError
from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import (decode_attention as
                                                  _decode_kernel)
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel)
from repro_torch.kernels.fused_mlp import fused_mlp as _mlp_kernel
from repro_torch.kernels.moe_experts import moe_experts as _moe_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

__all__ = ["attention", "decode_attention", "mlp", "moe_experts", "ssd",
           "rmsnorm",
           "uses_kernel", "IMPLS"]

IMPLS = ("auto", "cuda", "ref")


def uses_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether ``impl`` on tensors like ``x`` runs the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise DeviceUnavailableError(
            f"impl='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return x.is_cuda


def rmsnorm(x, w, eps: float = 1e-6):
    return _ref.rmsnorm_ref(x, w, eps)


def attention(q, k, v, bias=None, causal=True, impl: str = "auto",
              scale=None):
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv)."""
    if uses_kernel(impl, q):
        if _ag.needs_grad(q, k, v, bias):
            return _ag.FlashAttentionFn.apply(q, k, v, bias, causal, scale)
        return _flash_kernel(q, k, v, bias=bias, causal=causal, scale=scale)
    return _ref.flash_attention_ref(q, k, v, bias=bias, causal=causal,
                                    scale=scale)


def decode_attention(q, k, v, bias=None, impl: str = "auto", scale=None):
    """q: (B, Hq, Dk); k: (B, Hkv, S, Dk); v: (B, Hkv, S, Dv)."""
    if uses_kernel(impl, q):
        return _decode_kernel(q, k, v, bias=bias, scale=scale)
    return _ref.decode_attention_ref(q, k, v, bias=bias, scale=scale)


def mlp(x, w_norm, w_gate, w_up, w_down, eps: float = 1e-6,
        impl: str = "auto"):
    """Fused rmsnorm + SwiGLU.  x: (..., d), leading dims flattened."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if uses_kernel(impl, x):
        if _ag.needs_grad(x2, w_norm, w_gate, w_up, w_down):
            y = _ag.FusedMlpFn.apply(x2, w_norm, w_gate, w_up, w_down, eps)
        else:
            y = _mlp_kernel(x2, w_norm, w_gate, w_up, w_down, eps=eps)
    else:
        y = _ref.fused_mlp_ref(x2, w_norm, w_gate, w_up, w_down, eps=eps)
    return y.reshape(*lead, x.shape[-1])


def moe_experts(h, route, w_gate, w_up, w_down, impl: str = "auto"):
    """Dropless grouped SwiGLU experts over the tokens h (T, d); see
    :func:`repro_torch.kernels.moe_experts.moe_experts`.  Returns (T, d)
    float32.  The kernel has no backward: on the card it serves only."""
    if uses_kernel(impl, h):
        if _ag.needs_grad(h, w_gate, w_up, w_down):
            raise NotImplementedError(
                "moe_experts: the kernel has no backward; train with "
                "impl='ref'")
        return _moe_kernel(h, route, w_gate, w_up, w_down)
    return _ref.moe_experts_ref(h, route.rows, route.offsets, route.gates,
                                route.slots, w_gate, w_up, w_down)


def ssd(x, dt, A, B, C, chunk: int = 64, impl: str = "auto",
        init_state=None):
    """Mamba2 SSD scan; see :func:`ref.ssd_scan_ref` for the contract.

    Any length: the plain version pads a ragged sequence up to a chunk
    multiple with dt = 0 steps (a no-op on y and on the final state) and
    crops y; the kernel masks the ragged chunk the same way.  Both start
    from ``init_state`` (zeros when None).
    """
    if uses_kernel(impl, x):
        if _ag.needs_grad(x, dt, A, B, C, init_state):
            return _ag.SsdScanFn.apply(x, dt, A, B, C, chunk, init_state)
        return _ssd_kernel(x, dt, A, B, C, chunk=chunk,
                           init_state=init_state)
    return _ref.ssd_ref(x, dt, A, B, C, chunk=chunk, init_state=init_state)
