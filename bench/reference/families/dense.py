"""The reference of the dense decoder family (granite-3-2b), in PyTorch
and float32.

Pre-norm decoder blocks; RMSNorm; grouped query attention with rotary
embeddings (rotate-half), causal; a SwiGLU MLP.  Every layer is alike
and adds nothing to the loss.  The leaves are laid out as the port's
parameter tree: ``blocks/attn`` and ``blocks/mlp``, stacked on a leading
layer axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.model import layer, linear, rmsnorm, rope
from bench.reference.weights import matrix, ones, stacked


def head_dim(sz: dict) -> int:
    return sz.get("head_dim") or sz["d_model"] // sz["n_heads"]


def leaves(sz: dict) -> dict:
    """The laws of every leaf but ``embed``, ``final_ln``, ``lm_head``."""
    d, ff = sz["d_model"], sz["d_ff"]
    Hq, Hkv, hd = sz["n_heads"], sz["n_kv_heads"], head_dim(sz)
    attn = {"ln": ones(d), "wq": matrix(d, Hq * hd),
            "wk": matrix(d, Hkv * hd), "wv": matrix(d, Hkv * hd),
            "wo": matrix(Hq * hd, d)}
    mlp = {"ln": ones(d), "wg": matrix(d, ff), "wu": matrix(d, ff),
           "wd": matrix(ff, d)}
    return {"blocks": stacked({"attn": attn, "mlp": mlp}, sz["n_layers"])}


def attention(p: dict, sz: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x + causal GQA self-attention of rmsnorm(x).  x (B, S, d)."""
    B, S, _ = x.shape
    Hq, Hkv, hd = sz["n_heads"], sz["n_kv_heads"], head_dim(sz)
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


def block(params: dict, sz: dict, i: int, x: torch.Tensor,
          prec: str) -> tuple[torch.Tensor, None]:
    """Layer ``i``: attention, then the MLP; no term for the loss."""
    p = layer(params["blocks"], i)
    return mlp(p["mlp"], sz, attention(p["attn"], sz, x, prec), prec), None
