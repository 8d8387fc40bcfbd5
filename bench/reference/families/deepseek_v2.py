"""The reference of the DeepSeek-V2 family (deepseek-v2-lite), in PyTorch
and float32, after DeepSeek-V2's published modelling code
(``modeling_deepseek.py`` beside the model's ``config.json``;
arXiv:2405.04434).

Every layer is pre-norm multi-head latent attention, then an MLP: the
first ``first_dense_layers`` a SwiGLU of width ``dense_d_ff``, the rest
a mixture of experts.  Nothing is imported from the program.

- Attention (MLA, no q LoRA): q = h Wq, per head [nope (hd) ; rope
  (kr)]; [c ; k_pe] = h Wdkv, c normed by ``kv_ln``; k_nope = c Wuk, v =
  c Wuv, per head; one rope key k_pe shared by all heads.  The scores
  are q_nope . k_nope + q_pe . k_pe, causal, at scale ``m^2 /
  sqrt(hd + kr)`` with YaRN's ``m = 0.1 mscale_all_dim ln(factor) + 1``.
- YaRN (``DeepseekV2YarnRotaryEmbedding``): the frequencies
  ``theta^(-i / half)`` blended with themselves over ``factor`` by a
  ramp between the correction dims of beta_fast and beta_slow, cos and
  sin times ``m(factor, mscale) / m(factor, mscale_all_dim)``.
- MoE: the router's softmax over the E experts of h W_router (h the
  layer's normed input), the K best kept greedily, renormalised only
  where ``moe_renorm``; the output is the shared experts' SwiGLU of h
  plus, for each expert, gate x its SwiGLU over exactly the tokens
  routed to it: every token's K choices, none dropped.

Departures from the published code:

- The rope dims are paired rotate-half (the first and second halves of
  the 64), as the program and ``bench.reference.model.rope`` pair them.
  The published code first de-interleaves them (pairs 2i, 2i + 1), a
  fixed permutation of Wq's and Wdkv's rope columns; under weights drawn
  from the seed it is the same model.
- The training aux loss (``seq_aux``, alpha 0.001) is left out: no cell
  trains this model, and ``block`` returns no loss term.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.families.dense import mlp as dense_mlp
from bench.reference.model import layer, linear, rmsnorm
from bench.reference.weights import matrix, ones, stacked

F32 = torch.float32


def _widths(sz: dict) -> tuple[int, int, int, int]:
    """(heads, nope / v head dim, rope dim, kv rank)."""
    return (sz["n_heads"], sz["head_dim"], sz["rope_head_dim"],
            sz["kv_lora_rank"])


def leaves(sz: dict) -> dict:
    """The laws of every leaf but ``embed``, ``final_ln``, ``lm_head``:
    ``dense_blocks`` (the leading dense layers) and ``blocks`` (the MoE
    layers), as the port lays them out."""
    d, ff, E = sz["d_model"], sz["d_ff"], sz["n_experts"]
    H, hd, kr, r = _widths(sz)
    sf = sz["n_shared_experts"] * ff
    dff = sz["dense_d_ff"]
    attn = {"ln": ones(d), "wq": matrix(d, H * (hd + kr)),
            "wdkv": matrix(d, r + kr), "kv_ln": ones(r),
            "wuk": matrix(r, H * hd), "wuv": matrix(r, H * hd),
            "wo": matrix(H * hd, d)}
    dense = {"ln": ones(d), "wg": matrix(d, dff), "wu": matrix(d, dff),
             "wd": matrix(dff, d)}
    moe = {"ln": ones(d), "router": matrix(d, E, std=0.02),
           "wg": matrix(E, d, ff), "wu": matrix(E, d, ff),
           "wd": matrix(E, ff, d),
           "shared": {"wg": matrix(d, sf), "wu": matrix(d, sf),
                      "wd": matrix(sf, d)}}
    k = sz["first_dense_layers"]
    return {"dense_blocks": stacked({"attn": attn, "mlp": dense}, k),
            "blocks": stacked({"attn": attn, "mlp": moe},
                              sz["n_layers"] - k)}


def _m(factor: float, m: float) -> float:
    """YaRN's ``yarn_get_mscale``."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(sz: dict, device) -> tuple[torch.Tensor, float]:
    """The rope dims' frequencies (kr / 2,) and the factor on cos and
    sin, as ``DeepseekV2YarnRotaryEmbedding`` sets them."""
    D, theta, factor = sz["rope_head_dim"], sz["rope_theta"], sz["rope_factor"]
    freq_extra = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32,
                                              device=device) / D)
    if factor <= 1:
        return freq_extra, 1.0
    freq_inter = 1.0 / (factor * theta ** (torch.arange(
        0, D, 2, dtype=F32, device=device) / D))

    def corr(rotations):
        return (D * math.log(sz["rope_original_len"]
                             / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(sz["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(sz["rope_beta_slow"])), D - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(D // 2, dtype=F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = freq_inter * (1 - mask) + freq_extra * mask
    return inv, (_m(factor, sz["rope_mscale"])
                 / _m(factor, sz["rope_mscale_all_dim"]))


def softmax_scale(sz: dict) -> float:
    """``1 / sqrt(hd + kr)``, times YaRN's mscale_all_dim factor twice."""
    scale = 1.0 / math.sqrt(sz["head_dim"] + sz["rope_head_dim"])
    if sz["rope_factor"] > 1 and sz["rope_mscale_all_dim"]:
        scale *= _m(sz["rope_factor"], sz["rope_mscale_all_dim"]) ** 2
    return scale


def rope(x: torch.Tensor, pos: torch.Tensor, sz: dict) -> torch.Tensor:
    """x (B, S, H, kr), rotate-half pairs, YaRN's frequencies."""
    half = x.shape[-1] // 2
    inv, mscale = yarn(sz, x.device)
    ang = pos.to(F32)[:, None] * inv                    # (S, half)
    cos = (ang.cos() * mscale)[:, None]
    sin = (ang.sin() * mscale)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p: dict, sz: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x + causal multi-head latent attention of rmsnorm(x).  x (B, S,
    d)."""
    B, S, _ = x.shape
    H, hd, kr, r = _widths(sz)
    eps = sz["norm_eps"]
    h = rmsnorm(x, p["ln"], eps)
    pos = torch.arange(S, device=x.device)
    q = linear(h, p["wq"], prec).view(B, S, H, hd + kr)
    q_nope, q_pe = q[..., :hd], rope(q[..., hd:], pos, sz)
    kv = linear(h, p["wdkv"], prec)
    c = rmsnorm(kv[..., :r], p["kv_ln"], eps)
    k_pe = rope(kv[..., None, r:], pos, sz)[:, :, 0]     # (B, S, kr)
    k_nope = linear(c, p["wuk"], prec).view(B, S, H, hd)
    v = linear(c, p["wuv"], prec).view(B, S, H, hd)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe)) * softmax_scale(sz)
    keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return x + linear(o.reshape(B, S, H * hd), p["wo"], prec)


def _swiglu(h, wg, wu, wd, prec):
    return linear(F.silu(linear(h, wg, prec)) * linear(h, wu, prec), wd,
                  prec)


def route(p: dict, sz: dict, h: torch.Tensor, prec: str
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates, experts) (T, K) of the normed tokens h (T, d): the K
    largest of the router's softmax, greedy, renormalised where
    ``moe_renorm``."""
    scores = torch.softmax(linear(h, p["router"], prec), -1)
    w, e = scores.topk(sz["experts_per_token"], -1)
    if sz.get("moe_renorm", True):
        w = w / w.sum(-1, keepdim=True)
    return w, e


def moe(p: dict, sz: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x + the shared experts and the routed ones of rmsnorm(x); each
    expert runs over exactly the tokens routed to it, none dropped."""
    B, S, d = x.shape
    h = rmsnorm(x, p["ln"], sz["norm_eps"]).reshape(B * S, d)
    w, e = route(p, sz, h, prec)
    sh = p["shared"]
    out = _swiglu(h, sh["wg"], sh["wu"], sh["wd"], prec)
    for ex in range(sz["n_experts"]):
        tok, k = (e == ex).nonzero(as_tuple=True)   # a token once at most
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], p["wg"][ex], p["wu"][ex], p["wd"][ex], prec)
        out[tok] = out[tok] + w[tok, k, None] * y
    return x + out.view(B, S, d)


def block(params: dict, sz: dict, i: int, x: torch.Tensor,
          prec: str) -> tuple[torch.Tensor, None]:
    """Layer ``i``: MLA, then the dense MLP (the leading layers) or the
    MoE; no term for the loss."""
    k = sz["first_dense_layers"]
    if i < k:
        p = layer(params["dense_blocks"], i)
        return dense_mlp(p["mlp"], sz, attention(p["attn"], sz, x, prec),
                         prec), None
    p = layer(params["blocks"], i - k)
    return moe(p["mlp"], sz, attention(p["attn"], sz, x, prec), prec), None
