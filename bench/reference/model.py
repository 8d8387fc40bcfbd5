"""The plain reference of the decoder families, in PyTorch and float32.

It follows the equations of the models as the port's configurations
state them, written out here on plain tensors: no kernel, no cache, no
batching, and nothing imported from the program.  Matrix products run
with TF32 off (:func:`exact_matmul`).

What every family shares is here: the embedding, the loop over the
layers (each recomputed in the backward where training asks for it),
the final norm, the unembedding and the loss, and the pieces a layer is
built from (:func:`linear`, :func:`rmsnorm`, :func:`rope`).  A family's
layers are in ``bench/reference/families/<family>.py``, found by
``sz["family"]``: ``block(params, sz, i, x, prec)`` returns layer ``i``'s
output and the term it adds to the training loss (None for none).
``dense`` is granite-3-2b's.

``prec="fp8"`` is the control of the correctness check: every
projection's operands (activations and weights) are rounded to
float8_e4m3fn with one scale a tensor before the product, the next
precision below the bf16 that the configurations state.  Gradients pass
the rounding unchanged (straight through).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import checkpoint as _ckpt

from bench import families

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


def layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a tree stacked on a leading layer axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(params: dict, sz: dict, tokens: torch.Tensor, prec: str = "f32",
           remat: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The final normed hidden states (B, S, d), float32, and the sum of
    the terms the layers add to the loss (None for none).  With
    ``remat`` each layer is recomputed in the backward, so a training
    reference keeps one layer's activations at a time."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    block = families.reference(sz["family"]).block
    x, extra = params["embed"].to(F32)[tokens], None
    for i in range(sz["n_layers"]):
        if remat:
            x, term = _ckpt.checkpoint(block, params, sz, i, x, prec,
                                       use_reentrant=False)
        else:
            x, term = block(params, sz, i, x, prec)
        if term is not None:
            extra = term if extra is None else extra + term
    return rmsnorm(x, params["final_ln"], sz["norm_eps"]), extra


def head(params: dict, sz: dict) -> torch.Tensor:
    return (params["embed"].T if sz.get("tie_embeddings", False)
            else params["lm_head"])


def logits(params: dict, sz: dict, tokens: torch.Tensor, start: int = 0,
           prec: str = "f32") -> torch.Tensor:
    """Logits (S - start, V) float32 of one sequence ``tokens`` (S,) at
    positions start.. (the unembedding in float32 in both precisions, as
    the port computes it)."""
    with torch.no_grad(), exact_matmul():
        x, _ = hidden(params, sz, tokens[None], prec)
        return x[0, start:] @ head(params, sz).to(F32)


def loss(params: dict, sz: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean cross entropy over the labels >= 0 (B, S), plus the terms
    the layers add, with every layer recomputed in the backward."""
    x, extra = hidden(params, sz, tokens, prec, remat=True)
    lg = x @ head(params, sz).to(F32)
    ce = torch.logsumexp(lg, -1) - lg.gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    total = (ce * mask).sum() / mask.sum().clamp_min(1.0)
    return total if extra is None else total + extra
