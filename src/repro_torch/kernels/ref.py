"""Plain PyTorch versions of the LM kernels (the port of
``repro.kernels.ref``).

Each ``*_ref`` function defines what its Hopper kernel computes.  The
kernels' wrappers run them for CPU tensors, the models run them with
``impl="ref"``, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  They follow ``repro.kernels.ref`` op for op, except
where a docstring says otherwise.  The SSD scan's versions come with the
SSM slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rmsnorm_ref", "flash_attention_ref", "decode_attention_ref",
           "fused_mlp_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None = None, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Naive attention.

    q: (B, Hq, Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv); bias:
    (B, Sk) additive (padding masks).  GQA by repeating KV heads.  The
    causal mask lets query i see keys up to ``i + Sk - Sq``.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :].to(torch.float32)
    if causal:
        Sk = k.shape[2]
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Single-token attention.  q: (B, Hq, D); k/v: (B, Hkv, S, D).

    ``bias`` (B, S) masks cache slots past each sequence's length.
    """
    out = flash_attention_ref(q[:, :, None], k, v, bias=bias, causal=False,
                              scale=scale)
    return out[:, :, 0]


def fused_mlp_ref(x: torch.Tensor, w_norm: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm -> SwiGLU MLP.  x: (T, d); w_gate/w_up: (d, f); w_down:
    (f, d).  Products accumulate in float32.

    The normalized rows stay in float32, as in the TPU kernel
    (``repro/kernels/fused_mlp.py``), where ``repro.kernels.ref``'s
    version rounds them to x's type first.  In float32 the two agree; in
    bfloat16 they differ by that one rounding.
    """
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    h = xf * torch.rsqrt(var + eps) * w_norm.to(torch.float32)
    g = h @ w_gate.to(torch.float32)
    u = h @ w_up.to(torch.float32)
    a = torch.nn.functional.silu(g) * u
    return (a @ w_down.to(torch.float32)).to(x.dtype)
