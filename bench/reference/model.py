"""The plain reference of the dense decoder family, in PyTorch and
float32.

It follows the equations of the models as the port's configurations
state them, written out here on plain tensors: no kernel, no cache, no
batching, and nothing imported from the program.  Matrix products run
with TF32 off (:func:`exact_matmul`).

``dense`` (granite-3-2b): pre-norm decoder blocks; RMSNorm; grouped
query attention with rotary embeddings (rotate-half, theta 10,000),
causal; a SwiGLU MLP; tied embeddings.

``prec="fp8"`` is the control of the correctness check: every
projection's operands (activations and weights) are rounded to
float8_e4m3fn with one scale a tensor before the product, the next
precision below the bf16 that the configurations state.  Gradients pass
the rounding unchanged (straight through).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

F32 = torch.float32
PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0                # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8_e4m3fn with one scale (amax / 448), back in
    float32; the gradient passes unchanged."""
    d = t.detach()
    s = d.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (d / s).to(torch.float8_e4m3fn).to(F32) * s
    return t + (q - d)


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    w = w.to(F32)
    if prec == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D); pos (S,).  Rotate-half: the first and second
    halves of each head are the pairs, frequencies theta^(-i / half)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * freqs                  # (S, half)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]   # (S, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p: dict, sz: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x + causal GQA self-attention of rmsnorm(x).  x (B, S, d)."""
    B, S, _ = x.shape
    Hq, Hkv = sz["n_heads"], sz["n_kv_heads"]
    hd = sz.get("head_dim") or sz["d_model"] // Hq
    h = rmsnorm(x, p["ln"], sz["norm_eps"])
    pos = torch.arange(S, device=x.device)
    q = rope(linear(h, p["wq"], prec).view(B, S, Hq, hd), pos,
             sz["rope_theta"])
    k = rope(linear(h, p["wk"], prec).view(B, S, Hkv, hd), pos,
             sz["rope_theta"])
    v = linear(h, p["wv"], prec).view(B, S, Hkv, hd)
    G = Hq // Hkv                # query head j reads KV head j // G
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return x + linear(o.reshape(B, S, Hq * hd), p["wo"], prec)


def mlp(p: dict, sz: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    h = rmsnorm(x, p["ln"], sz["norm_eps"])
    a = F.silu(linear(h, p["wg"], prec)) * linear(h, p["wu"], prec)
    return x + linear(a, p["wd"], prec)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def blocks(params: dict, sz: dict, i: int, x: torch.Tensor,
           prec: str) -> torch.Tensor:
    """Layer ``i`` of the model."""
    if sz["family"] != "dense":
        raise ValueError(f"no reference for family {sz['family']!r}")
    p = _layer(params["blocks"], i)
    return mlp(p["mlp"], sz, attention(p["attn"], sz, x, prec), prec)


def hidden(params: dict, sz: dict, tokens: torch.Tensor, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final normed hidden states (B, S, d), float32.  With ``remat``
    each layer is recomputed in the backward, so a training reference
    keeps one layer's activations at a time."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    x = params["embed"].to(F32)[tokens]
    for i in range(sz["n_layers"]):
        if remat:
            x = _ckpt.checkpoint(blocks, params, sz, i, x, prec,
                                 use_reentrant=False)
        else:
            x = blocks(params, sz, i, x, prec)
    return rmsnorm(x, params["final_ln"], sz["norm_eps"])


def head(params: dict, sz: dict) -> torch.Tensor:
    return (params["embed"].T if sz.get("tie_embeddings", False)
            else params["lm_head"])


def logits(params: dict, sz: dict, tokens: torch.Tensor, start: int = 0,
           prec: str = "f32") -> torch.Tensor:
    """Logits (S - start, V) float32 of one sequence ``tokens`` (S,) at
    positions start.. (the unembedding in float32 in both precisions, as
    the port computes it)."""
    with torch.no_grad(), exact_matmul():
        x = hidden(params, sz, tokens[None], prec)[0, start:]
        return x @ head(params, sz).to(F32)


def loss(params: dict, sz: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean cross entropy over the labels >= 0 (B, S), with every layer
    recomputed in the backward."""
    x = hidden(params, sz, tokens, prec, remat=True)
    lg = x @ head(params, sz).to(F32)
    ce = torch.logsumexp(lg, -1) - lg.gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)
