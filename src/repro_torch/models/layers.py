"""Model building blocks for the dense, MoE, MLA, SSM, hybrid,
encoder-decoder and vision-prefix families (the port of
``repro.models.layers``).

Parameters are declared with :class:`ParamDef` (shape, logical axes,
init law) and made by :func:`init_tree` from one ``torch.Generator`` on
the target device.  The blocks are plain functions on tensors; the LM
kernels are reached through :mod:`repro_torch.kernels.ops` only.  The
decode path (``S == 1``) builds no device tensor from host data and
reads nothing back to the host, so one CUDA graph can capture a whole
decode step (:mod:`repro_torch.runtime.compiled_step`).

Prefill attention takes the flash kernel wherever ``cfg.attn_impl``
does (``"auto"`` on the card); the plain route is the reference's
chunked online-softmax scan (:func:`_chunked_attention`) when
``cfg.attn_chunk`` is set and the keys are longer than a chunk, else the
oracle.  The two compute the same function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.launch import f32_matmul
from repro_torch.kernels.moe_experts import dispatch as moe_dispatch
from repro_torch.models.config import ModelConfig, yarn_m
from repro_torch.obs.tracer import get_tracer, maybe_span

__all__ = ["ParamDef", "init_tree", "moe_stats", "rmsnorm", "rope",
           "yarn_of", "rope_freqs", "embed_tokens",
           "unembed", "softmax_cross_entropy", "attn_defs",
           "attention_block", "mla_defs", "mla_attention_block",
           "mlp_defs", "mlp_block", "moe_defs", "moe_route", "moe_block",
           "ExpertChoices", "expert_choices", "active_choices",
           "recomputing", "decode_attn_cache", "mamba2_defs",
           "mamba2_block", "mamba2_decode_step"]


# ----------------------------------------------------------------------
# declarative parameters
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | ssm_a | dt_bias
    scale: float | None = None  # stddev override (default: 1/sqrt(fan_in))

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def _leaves(defs: Any, prefix: tuple = ()):
    """(path, ParamDef) in sorted-key order, as ``jax.tree`` flattens."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for key in sorted(defs):
        yield from _leaves(defs[key], prefix + (key,))


def init_tree(defs: Any, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> Any:
    """Values for a tree of :class:`ParamDef`, drawn in sorted-key order
    from ``generator`` (which must live on ``device``)."""
    def build(d):
        if isinstance(d, ParamDef):
            return _init_one(d, generator, dtype, device)
        return {k: build(d[k]) for k in sorted(d)}
    return build(defs)


def _init_one(d: ParamDef, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init in ("ssm_a", "dt_bias"):     # kept in float32 whatever dtype
        u = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=device)
        if d.init == "ssm_a":               # A = -uniform[1, 16)
            return -(u * 15.0 + 1.0)
        u = u * (1e-1 - 1e-3) + 1e-3        # softplus^-1(uniform[1e-3, 1e-1])
        return torch.log(torch.expm1(u))
    if d.init != "normal":
        raise ValueError(f"unknown init law {d.init!r}")
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, w, eps)


def yarn_of(cfg: ModelConfig) -> tuple | None:
    """The config's YaRN settings for :func:`rope` (factor, original
    length, beta_fast, beta_slow, mscale, mscale_all_dim), or None for
    plain rotary embeddings (``rope_factor`` <= 1)."""
    if cfg.rope_factor <= 1:
        return None
    return (cfg.rope_factor, cfg.rope_original_len, cfg.rope_beta_fast,
            cfg.rope_beta_slow, cfg.rope_mscale, cfg.rope_mscale_all_dim)


def rope_freqs(D: int, theta: float, yarn: tuple | None,
               device: torch.device) -> tuple[torch.Tensor, float]:
    """The D / 2 rotary frequencies and the factor on cos and sin.

    Plain: ``theta^(-i / (D / 2))``.  YaRN (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): those frequencies (extrapolated)
    and the same over ``factor`` (interpolated), blended by
    ``1 - clamp((i - low) / (high - low), 0, 1)`` with ``low = floor(c(
    beta_fast))``, ``high = ceil(c(beta_slow))``, ``c(r) = D ln(original
    / (2 pi r)) / (2 ln theta)`` (clamped to [0, D - 1]); cos and sin
    times ``m(factor, mscale) / m(factor, mscale_all_dim)``."""
    half = D // 2
    i = torch.arange(0, half, dtype=torch.float32, device=device)
    # a Python base: no host-to-device copy, so a CUDA graph can capture it
    freqs = torch.pow(float(theta), -i / half)
    if yarn is None:
        return freqs, 1.0
    factor, original, fast, slow, m, m_all = yarn

    def dim(rotations):
        return D * math.log(original / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(dim(fast)), 0)
    high = min(math.ceil(dim(slow)), D - 1)
    if low == high:
        high += 0.001
    keep = 1.0 - ((i - low) / (high - low)).clamp(0.0, 1.0)
    freqs = freqs / factor * (1.0 - keep) + freqs * keep
    return freqs, yarn_m(factor, m) / yarn_m(factor, m_all)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         yarn: tuple | None = None) -> torch.Tensor:
    """Rotary embedding, rotate-half form.  x: (..., S, H, D); pos: (S,)
    for a shared position run, or (B, 1) per sequence at decode.  With
    ``yarn`` (:func:`yarn_of`) the frequencies and factor of
    :func:`rope_freqs`."""
    D = x.shape[-1]
    half = D // 2
    freqs, mscale = rope_freqs(D, theta, yarn, x.device)
    ang = pos[..., None].to(torch.float32) * freqs        # (..., S, half)
    ang = ang[..., None, :]                               # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in float32, as the reference computes them."""
    return x.to(torch.float32) @ head.to(torch.float32)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """logsumexp minus the gold logit, in the logits' type (float32 as
    :func:`unembed` gives them).  labels: integer, >= 0."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return lse - gold


# ----------------------------------------------------------------------
# attention block (GQA / MQA; KV cache aware)
# ----------------------------------------------------------------------
def attn_defs(cfg: ModelConfig) -> dict:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {
        "ln": ParamDef((d,), ("embed",), "ones"),
        "wq": ParamDef((d, Hq * hd), ("embed", "heads")),
        "wk": ParamDef((d, Hkv * hd), ("embed", "kv_heads")),
        "wv": ParamDef((d, Hkv * hd), ("embed", "kv_heads")),
        "wo": ParamDef((Hq * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((Hq * hd,), ("heads",), "zeros")
        defs["bk"] = ParamDef((Hkv * hd,), ("kv_heads",), "zeros")
        defs["bv"] = ParamDef((Hkv * hd,), ("kv_heads",), "zeros")
    return defs


def _write_cache(c: torch.Tensor, new: torch.Tensor,
                 index: int | torch.Tensor) -> None:
    """Write ``new`` (B, H, S, D) into the cache ``c`` (B, H, Smax, D)
    at position ``index`` (a scalar, or (B,) per sequence), in place.

    The start is clamped to ``[0, Smax - S]``, as ``dynamic_update_slice``
    clamps it in the reference.
    """
    B, _, S, _ = new.shape
    Smax = c.shape[2]
    new = new.to(c.dtype)
    if isinstance(index, torch.Tensor) and (index.dim() == 1 or S == 1):
        idx = index.to(device=c.device, dtype=torch.long).clamp(0, Smax - S)
        if S == 1:          # decode: one scatter, no host read of index
            idx = idx.expand(B)
            c[torch.arange(B, device=c.device), :, idx] = new[:, :, 0]
            return
        for b, i in enumerate(idx.tolist()):
            c[b, :, i:i + S] = new[b]
        return
    i = min(max(int(index), 0), Smax - S)
    c[:, :, i:i + S] = new


def attention_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    pos: torch.Tensor, cache: dict | None = None,
                    cache_index: int | torch.Tensor | None = None,
                    cross_kv: tuple | None = None,
                    causal: bool = True) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm attention with residual.  x: (B, S, d).

    cache: {"k", "v"} (B, Hkv, Smax, D), written at ``cache_index`` (a
    scalar or a (B,) vector of per-slot positions) IN PLACE, where the
    reference returns new arrays.  With ``cfg.kv_repeat_to > n_kv_heads``
    and a cache, the KV heads are repeated up to ``kv_repeat_to`` (the
    cache is sized to match, :func:`decode_attn_cache`).  With S == 1 the
    query attends to the cache under the mask ``arange(Smax) <= index``;
    otherwise to the fresh keys and values (a prefill starts at 0).
    cross_kv: the encoder's (k, v) (B, Hkv, Senc, D), not roped, for
    whisper's cross-attention: the query (roped at ``pos``) attends to
    all of them, no cache is written, and at S == 1 there is no bias.
    Returns (x + attn_out, cache).
    """
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(x, p["ln"], cfg.norm_eps)

    q = h @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = rope(q.reshape(B, S, Hq, hd), pos, cfg.rope_theta)

    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = h @ p["wk"]
        v = h @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = rope(k.reshape(B, S, Hkv, hd), pos,
                 cfg.rope_theta).transpose(1, 2)
        v = v.reshape(B, S, Hkv, hd).transpose(1, 2)  # (B, Hkv, S, D)
        if cfg.kv_repeat_to > Hkv and cache is not None:
            # each KV head repeated rep times in a row, as jnp.repeat
            rep = cfg.kv_repeat_to // Hkv
            k, v = (t[:, :, None].expand(B, Hkv, rep, S, hd).reshape(
                B, Hkv * rep, S, hd) for t in (k, v))

    if cache is not None and cross_kv is None:
        _write_cache(cache["k"], k, cache_index)
        _write_cache(cache["v"], v, cache_index)
        if S == 1:                 # decode attends against the cache;
            k, v = cache["k"], cache["v"]   # prefill against the fresh
                                            # projections (from 0)

    qh = q.transpose(1, 2)                            # (B, Hq, S, D)
    if S == 1:
        bias = (None if cross_kv is not None       # every frame is valid
                else _length_bias(cache_index, B, k.shape[2], x.device))
        out = ops.decode_attention(qh[:, :, 0], k, v, bias=bias,
                                   impl=cfg.attn_impl)      # (B, Hq, D)
        out = out.reshape(B, 1, Hq * hd)
    else:
        out = _prefill_attention(qh, k, v, cfg, causal)
        out = out.transpose(1, 2).reshape(B, S, Hq * hd)
    return x + (out @ p["wo"]).to(x.dtype), cache


def _prefill_attention(q, k, v, cfg: ModelConfig, causal: bool,
                       scale: float | None = None) -> torch.Tensor:
    """Attention over S > 1 queries: the flash kernel where
    ``cfg.attn_impl`` takes it, else the plain route, the reference's
    chunked scan when ``cfg.attn_chunk`` is set and Sk > attn_chunk (its
    ``attention_xla``), else the oracle."""
    chunk = cfg.attn_chunk
    if (chunk and k.shape[2] > chunk
            and not ops.uses_kernel(cfg.attn_impl, q)):
        return _chunked_attention(q, k, v, None, causal, chunk, scale)
    return ops.attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                         scale=scale)


def _chunked_attention(q, k, v, bias, causal: bool, chunk: int,
                       scale: float | None = None) -> torch.Tensor:
    """The reference's online-softmax scan over key blocks of ``chunk``
    (``repro.models.layers._chunked_attention``), the flash dataflow in
    plain PyTorch: the (Sq, Sk) logits never exist at once.  Ragged keys
    (whisper's 1500 frames) are padded to a chunk multiple and masked by
    a -1e30 bias; a row whose keys are all masked gives 0.  q: (B, Hq,
    Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv); bias (B, Sk) or
    None.  Returns (B, Hq, Sq, Dv) in q's type."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    f32 = torch.float32
    dev = q.device
    offs = Sk - Sq                 # queries sit at the end of the keys
    pad = (-Sk) % chunk
    if pad:
        if bias is None:
            bias = torch.zeros((B, Sk), dtype=f32, device=dev)
        bias = torch.nn.functional.pad(bias.to(f32), (0, pad),
                                       value=-1e30)
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        Sk += pad
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.to(f32) * scale
    qpos = torch.arange(Sq, device=dev)[:, None] + offs
    m = torch.full((B, Hq, Sq), -1e30, dtype=f32, device=dev)
    l = torch.zeros((B, Hq, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, Hq, Sq, Dv), dtype=f32, device=dev)
    for k0 in range(0, Sk, chunk):
        kb, vb = k[:, :, k0:k0 + chunk], v[:, :, k0:k0 + chunk]
        if G > 1:                  # each KV head serves G query heads
            kb = kb[:, :, None].expand(B, Hkv, G, chunk, D).reshape(
                B, Hq, chunk, D)
            vb = vb[:, :, None].expand(B, Hkv, G, chunk, Dv).reshape(
                B, Hq, chunk, Dv)
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kb.to(f32))
        if bias is not None:
            logits = logits + bias[:, None, None, k0:k0 + chunk].to(f32)
        if causal:
            kpos = k0 + torch.arange(chunk, device=dev)[None, :]
            logits = torch.where(kpos <= qpos, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(m_new[..., None] > -5e29, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vb.to(f32))
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _length_bias(index: int | torch.Tensor, B: int, Smax: int,
                 device: torch.device) -> torch.Tensor:
    """The decode mask (B, Smax) float32: 0 at positions <= ``index`` (a
    scalar, or (B,) per slot), -1e30 past them."""
    if not isinstance(index, torch.Tensor):
        index = torch.tensor(index, device=device)
    idxb = index[:, None] if index.dim() == 1 else index
    keep = torch.arange(Smax, device=device)[None, :] <= idxb
    return torch.where(keep, 0.0, -1e30).to(torch.float32).expand(B, Smax)


# ----------------------------------------------------------------------
# MLA: multi-head latent attention (minicpm3)
# ----------------------------------------------------------------------
def mla_defs(cfg: ModelConfig) -> dict:
    """MLA's leaves.  With ``q_lora_rank`` 0 q is one projection ``wq``
    (DeepSeek-V2-Lite's ``q_proj``), where the reference builds a d-wide
    down-projection and its norm."""
    d, hd, Hq = cfg.d_model, cfg.hd, cfg.n_heads
    r, kr, qr = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
    q = ({"wdq": ParamDef((d, qr), ("embed", None)),
          "q_ln": ParamDef((qr,), (None,), "ones"),
          "wuq": ParamDef((qr, Hq * (hd + kr)), (None, "heads"))} if qr
         else {"wq": ParamDef((d, Hq * (hd + kr)), ("embed", "heads"))})
    return {
        "ln": ParamDef((d,), ("embed",), "ones"),
        **q,
        "wdkv": ParamDef((d, r + kr), ("embed", None)),
        "kv_ln": ParamDef((r,), (None,), "ones"),
        "wuk": ParamDef((r, Hq * hd), (None, "heads")),
        "wuv": ParamDef((r, Hq * hd), (None, "heads")),
        "wo": ParamDef((Hq * hd, d), ("heads", "embed")),
    }


def _latent_rows(c_kv: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """[c_kv ; k_rope] (B, S, r + kr).  When the two are the column
    halves of one buffer's rows (:func:`decode_attn_cache`'s layout) this
    is a view of that buffer; otherwise a copy."""
    B, S, r = c_kv.shape
    kr = k_rope.shape[-1]
    joint = (k_rope.data_ptr() == c_kv.data_ptr() + r * c_kv.element_size()
             and k_rope.dtype == c_kv.dtype and c_kv.stride(-1) == 1
             and k_rope.stride() == c_kv.stride()
             and c_kv.stride(1) >= r + kr)
    if joint:
        return c_kv.as_strided((B, S, r + kr), c_kv.stride())
    return torch.cat([c_kv, k_rope], -1)


def mla_attention_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        pos: torch.Tensor, cache: dict | None = None,
                        cache_index: int | torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention (MiniCPM3 / DeepSeek style).

    q from ``wq`` where the config has no q LoRA, else ``wuq`` over the
    normed ``wdq`` down-projection.  The softmax scale is
    ``1 / sqrt(hd + kr)`` times YaRN's ``cfg.yarn_mscale`` (1 without
    YaRN), and the rope dims take YaRN's frequencies where it is on.

    cache: {"c_kv" (B, Smax, r), "k_rope" (B, Smax, kr)}, written at
    ``cache_index`` in place.  At S == 1 (decode) the absorbed form: the
    query projected into the latent space attends, as MQA (Hkv = 1,
    Dk = r + kr, Dv = r), against [c_kv ; k_rope] read from the cache,
    through ``ops.decode_attention``; the float32 ``wuv`` up-projection
    follows.  ``mla_absorb="always"`` takes the same form at S > 1, over
    the prompt's own latent rows, causal through ``ops.attention``
    (minicpm3-4b: Dk 288, Dv 256).  Otherwise (``mla_absorb="decode"``)
    a prefill up-projects K and V once and ``ops.attention`` runs causal
    at Dk = hd + kr, Dv = hd.  Returns (x + attn_out, cache).
    """
    B, S, _ = x.shape
    hd, Hq = cfg.hd, cfg.n_heads
    r, kr = cfg.kv_lora_rank, cfg.rope_head_dim
    absorb = cfg.mla_absorb == "always" or S == 1
    f32 = torch.float32
    yarn = yarn_of(cfg)
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    if "wq" in p:
        q = h @ p["wq"]
    else:
        q = rmsnorm(h @ p["wdq"], p["q_ln"], cfg.norm_eps) @ p["wuq"]
    q = q.reshape(B, S, Hq, hd + kr)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = rope(q_rope, pos, cfg.rope_theta, yarn)

    dkv = h @ p["wdkv"]                                 # (B, S, r + kr)
    c_kv = rmsnorm(dkv[..., :r], p["kv_ln"], cfg.norm_eps)
    k_rope = rope(dkv[..., None, r:], pos, cfg.rope_theta, yarn)[:, :, 0]

    if cache is not None:      # the (B, Smax, D) leaves as (B, 1, Smax, D)
        _write_cache(cache["c_kv"][:, None], c_kv[:, None], cache_index)
        _write_cache(cache["k_rope"][:, None], k_rope[:, None], cache_index)
        if S == 1:
            c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    wuk = p["wuk"].reshape(r, Hq, hd)
    wuv = p["wuv"].reshape(r, Hq, hd)
    scale = cfg.yarn_mscale / math.sqrt(hd + kr)
    if absorb:                 # MQA over the latent rows
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(f32),
                             wuk.to(f32)).to(x.dtype)
        q_eff = torch.cat([q_lat, q_rope], -1)          # (B, S, Hq, r+kr)
        k_eff = _latent_rows(c_kv, k_rope)[:, None]     # (B, 1, Sk, r+kr)
        v_eff = c_kv[:, None]                           # (B, 1, Sk, r)
        if S == 1:             # decode: the cache's rows up to the index
            bias = _length_bias(cache_index, B, k_eff.shape[2], x.device)
            ctx = ops.decode_attention(q_eff[:, 0], k_eff, v_eff, bias=bias,
                                       scale=scale, impl=cfg.attn_impl)
            ctx = ctx[:, None]                          # (B, 1, Hq, r)
        else:                  # the absorbed prefill over the prompt
            ctx = _prefill_attention(q_eff.transpose(1, 2), k_eff, v_eff,
                                     cfg, causal=True, scale=scale)
            ctx = ctx.transpose(1, 2)                   # (B, S, Hq, r)
        out = torch.einsum("bshr,rhd->bshd", ctx.to(f32), wuv.to(f32))
    else:                      # prefill: K and V up-projected once
        k_nope = torch.einsum("btr,rhd->bthd", c_kv.to(f32),
                              wuk.to(f32)).to(x.dtype)
        v = torch.einsum("btr,rhd->bthd", c_kv.to(f32),
                         wuv.to(f32)).to(x.dtype)
        Sk = c_kv.shape[1]
        k_rope_h = k_rope[:, :, None].expand(B, Sk, Hq, kr).to(x.dtype)
        k_full = torch.cat([k_nope, k_rope_h], -1)      # (B, Sk, Hq, hd+kr)
        q_full = torch.cat([q_nope.to(x.dtype), q_rope], -1)
        ctx = _prefill_attention(q_full.transpose(1, 2),
                                 k_full.transpose(1, 2), v.transpose(1, 2),
                                 cfg, causal=True, scale=scale)
        out = ctx.transpose(1, 2).to(f32)               # (B, S, Hq, hd)
    out = out.reshape(B, S, Hq * hd).to(x.dtype)
    return x + out @ p["wo"], cache


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig, ff: int = 0) -> dict:
    """A SwiGLU MLP's leaves, of width ``ff`` (default ``cfg.d_ff``)."""
    d, ff = cfg.d_model, ff or cfg.d_ff
    return {
        "ln": ParamDef((d,), ("embed",), "ones"),
        "wg": ParamDef((d, ff), ("embed", "ff")),
        "wu": ParamDef((d, ff), ("embed", "ff")),
        "wd": ParamDef((ff, d), ("ff", "embed")),
    }


def mlp_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    y = ops.mlp(x, p["ln"], p["wg"], p["wu"], p["wd"], eps=cfg.norm_eps,
                impl=cfg.attn_impl)
    return x + y.reshape(x.shape)


# ----------------------------------------------------------------------
# MoE: top-k experts with grouped capacity dispatch
# ----------------------------------------------------------------------
def moe_defs(cfg: ModelConfig) -> dict:
    """The router and the routed experts' leaves; with shared experts
    also ``shared``, one SwiGLU of width ``n_shared_experts * d_ff``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "ln": ParamDef((d,), ("embed",), "ones"),
        "router": ParamDef((d, E), ("embed", None), scale=0.02),
        "wg": ParamDef((E, d, ff), ("experts", "embed", "expert_ff")),
        "wu": ParamDef((E, d, ff), ("experts", "embed", "expert_ff")),
        "wd": ParamDef((E, ff, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        shared = mlp_defs(cfg, cfg.n_shared_experts * ff)
        del shared["ln"]                # the shared experts read ln too
        defs["shared"] = shared
    return defs


def moe_route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The router: (h, gates, topw, tope).  h = rmsnorm(x) (B, S, d);
    gates the float32 softmax over the E experts (B, S, E); tope the K
    chosen experts of each token, best first, and topw their gates,
    renormalised to sum 1 where ``cfg.moe_renorm`` (both (B, S, K))."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    gates = torch.softmax(h.to(torch.float32)
                          @ p["router"].to(torch.float32), dim=-1)
    topw, tope = torch.topk(gates, cfg.experts_per_token, dim=-1)
    if cfg.moe_renorm:
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return h, gates, topw, tope


def _renormalised(gates: torch.Tensor, experts: torch.Tensor,
                  renorm: bool = True) -> torch.Tensor:
    """The gates of ``experts``, renormalised to sum 1 (unless not
    ``renorm``)."""
    w = gates.gather(-1, experts)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9) if renorm else w


class ExpertChoices:
    """What :func:`expert_choices` yields: ``chosen`` holds each
    ``moe_block`` call's own router choices (B, S, K), best first, in
    call order.  With ``replay`` (such a list) each call takes the next
    entry as its choices instead, weighted by its own gates (renormalised
    to sum 1 where the config renormalises)."""

    def __init__(self, replay: list | None = None):
        self.chosen: list[torch.Tensor] = []
        self.replay = replay

    def take(self, gates: torch.Tensor, topw: torch.Tensor,
             tope: torch.Tensor, renorm: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor]:
        self.chosen.append(tope)
        if self.replay is None:
            return topw, tope
        forced = self.replay[len(self.chosen) - 1]
        return _renormalised(gates, forced, renorm), forced


class _Recompute:
    """Stands in for the :class:`ExpertChoices` of an ``expert_choices``
    block while a checkpoint recomputes a layer: the same operations as
    the layer's first pass, recording nothing.  Its calls replay
    ``replay`` (the entries the first pass replayed) or, where the first
    pass took its own router's choices, take them again (the recompute
    gives the same)."""

    def __init__(self, replay: list | None):
        self._replay = None if replay is None else iter(replay)

    def take(self, gates: torch.Tensor, topw: torch.Tensor,
             tope: torch.Tensor, renorm: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor]:
        if self._replay is None:
            return topw, tope
        tope = next(self._replay)
        return _renormalised(gates, tope, renorm), tope


_CHOICES: ExpertChoices | _Recompute | None = None   # set by the two below


@contextlib.contextmanager
def expert_choices(replay: list | None = None) -> Iterator[ExpertChoices]:
    """Within the ``with``, every ``moe_block`` call records its router's
    choices in the yielded :class:`ExpertChoices` and, given ``replay``,
    takes the recorded choices of another run instead: to compare two
    routes of one model on the same expert choices, and to count how
    often their own routers differ.  An eager-only instrument: a CUDA
    graph replays whatever its capture recorded.  Under ``remat`` a
    layer's recompute takes what its first pass took
    (``models/model.py``'s ``_remat``, :func:`recomputing`)."""
    global _CHOICES
    outer, _CHOICES = _CHOICES, ExpertChoices(replay)
    try:
        yield _CHOICES
    finally:
        _CHOICES = outer


def active_choices() -> ExpertChoices | None:
    """The :class:`ExpertChoices` of the innermost ``expert_choices``
    block, if any (None during a recompute)."""
    return _CHOICES if isinstance(_CHOICES, ExpertChoices) else None


@contextlib.contextmanager
def recomputing(replay: list | None) -> Iterator[None]:
    """Within the ``with``, ``moe_block`` calls repeat a layer's first
    pass under ``expert_choices`` (see :class:`_Recompute`) and record
    nothing."""
    global _CHOICES
    outer, _CHOICES = _CHOICES, _Recompute(replay)
    try:
        yield
    finally:
        _CHOICES = outer


_MOE_STATS: list | None = None      # set by moe_stats


@contextlib.contextmanager
def moe_stats() -> Iterator[list]:
    """Within the ``with``, every ``moe_block`` call appends its
    load-balance statistics (me, ce) to the yielded list: the mean
    router gate and the share of first choices of each expert over its
    tokens, (E,) float32 each, me with its gradient.  A remat recompute
    in a backward run inside the block appends too (unless it repeats
    an ``expert_choices`` pass), so read them before the backward.  A
    sharded train step averages them over the data shards (whose token
    counts are equal) before forming the loss, so the aux loss is the
    whole batch's, as one device computes it."""
    global _MOE_STATS
    outer, _MOE_STATS = _MOE_STATS, []
    try:
        yield _MOE_STATS
    finally:
        _MOE_STATS = outer


class _ExpertMatmul(torch.autograd.Function):
    """``torch.bmm(a, w, out_dtype=torch.float32)`` with a backward (the
    op has no derivative): the float32 products that the CPU route's
    autograd forms, each gradient cast to its operand's type."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return f32_matmul(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        f32 = torch.float32
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, w.to(f32).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(a.to(f32).transpose(1, 2), g).to(w.dtype)
        return ga, gw


def _expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, k) @ (E, k, n) with float32 sums and a float32 result, as
    the reference's ``preferred_element_type=float32``
    (:func:`~repro_torch.kernels.launch.f32_matmul`).  A training call on
    the card goes through :class:`_ExpertMatmul`."""
    if a.is_cuda and torch.is_grad_enabled() and (a.requires_grad
                                                  or w.requires_grad):
        return _ExpertMatmul.apply(a, w)
    return f32_matmul(a, w)


def moe_block(p: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity dispatch in ``G = cfg.moe_groups or B``
    groups, or with ``cfg.moe_dropless`` the dropless route
    (:func:`_dropless_moe`).  x: (B, S, d).  Returns (x + moe_out, aux),
    aux the Switch load-balance loss E * sum_e f_e P_e (0 on the
    dropless route).

    The reference's semantics, kept exactly: per group of T tokens, each
    expert takes ``cap = max(ceil(T K / E * capacity_factor), K)`` of
    them in order (the exclusive rank of a one-hot cumsum), dropping the
    rest.  Its (E, cap) token map is a scatter in which every dropped
    choice of expert e writes "no token" to slot cap - 1, after the kept
    token of rank cap - 1 wrote there; JAX applies it in order, so when
    e overflows that kept token loses e's output too.  Here each (e,
    slot) has one writer and that last-write-wins outcome is built in.
    The combine adds a token's K scaled expert outputs in x's type, in
    ascending expert id (the reference's scatter-add order over the
    flat (expert, slot) map), one rounding an add, from zero: no
    atomics, so graph and eager give the same bits.  The expert FFN is
    three ``torch.bmm`` over (E, G * cap, d), as the reference leaves
    its einsums to XLA.  No step reads the device on the host and no
    shape depends on the data, so a CUDA graph can capture it.
    """
    if cfg.moe_dropless:
        return _dropless_moe(p, cfg, x)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    G = cfg.moe_groups or B
    T = (B * S) // G
    cap = max(int(math.ceil(T * K / E * cfg.capacity_factor)), K)
    dev = x.device

    h, gates, topw, tope = moe_route(p, cfg, x)
    if _CHOICES is not None:
        topw, tope = _CHOICES.take(gates, topw, tope)
    h = h.reshape(G, T, d)
    flat_e = tope.reshape(G, T * K)
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).long()
    pos = (onehot.cumsum(1) - onehot).gather(2, flat_e[..., None])[..., 0]
    keep = pos < cap
    # expert e overflows: its slot cap - 1 ends up empty (see above)
    over = onehot.sum(1) > cap                                # (G, E)
    kept = keep & ~(over.gather(1, flat_e) & (pos == cap - 1))
    slot = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    cell = flat_e * cap + slot                                # (G, T*K)
    # the (E * cap) token map, one writer a cell; the rest point at the
    # zero row T (dropped choices go to a spare cell past the map)
    tok = torch.arange(T * K, device=dev).expand(G, -1) // K
    idx = torch.full((G, E * cap + 1), T, dtype=torch.long, device=dev)
    idx.scatter_(1, torch.where(kept, cell, E * cap), tok)
    idx = idx[:, :E * cap]
    h_pad = torch.cat([h, h.new_zeros(G, 1, d)], 1)           # (G, T+1, d)
    buf = h_pad.gather(1, idx[..., None].expand(-1, -1, d))   # (G, E*cap, d)

    # the expert FFN over (E, G * cap, d): bf16 operands, float32 sums
    buf = buf.reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
    g = _expert_matmul(buf, p["wg"])
    u = _expert_matmul(buf, p["wu"])
    a = (torch.nn.functional.silu(g) * u).to(x.dtype)
    y = _expert_matmul(a, p["wd"]).to(x.dtype)
    y = y.reshape(E, G, cap, d).transpose(0, 1).reshape(G, E * cap, d)

    # combine: each token's K contributions in ascending expert id
    yk = y.gather(1, cell[..., None].expand(-1, -1, d))       # (G, T*K, d)
    w = torch.where(kept, topw.reshape(G, T * K), 0.0).to(x.dtype)
    yk = (yk * w[..., None]).reshape(G, T, K, d)
    order = tope.reshape(G, T, K).argsort(-1)
    yk = yk.gather(2, order[..., None].expand(-1, -1, -1, d))
    out = yk[:, :, 0]
    for j in range(1, K):
        out = out + yk[:, :, j]
    out = out.reshape(B, S, d)

    me = gates.mean((0, 1))                                   # (E,)
    ce = (tope[..., 0, None] == torch.arange(E, device=dev)).to(
        torch.float32).mean((0, 1))
    if _MOE_STATS is not None and not isinstance(_CHOICES, _Recompute):
        _MOE_STATS.append((me, ce))
    return x + out, E * torch.sum(me * ce)


def _dropless_moe(p: dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V2's MoE: every token's top-K choices run, none dropped.

    The router (:func:`moe_route`, gates renormalised only where
    ``cfg.moe_renorm``) and the sort by expert (``moe_dispatch``: on the
    device, no host read) run inside the ``moe.dispatch`` span; the
    routed experts run through ``ops.moe_experts`` (float32 out, each
    token's K gated outputs added in ascending expert id), and the
    shared experts, where the config has them, through ``ops.mlp`` on x
    with the router's norm weight ``ln``; ``moe.layer`` spans the whole.
    Returns (x + (routed + shared) in x's type, 0): no aux loss."""
    B, S, d = x.shape
    tracer = get_tracer()
    with maybe_span(tracer, "moe.layer", cat="model"):
        with maybe_span(tracer, "moe.dispatch", cat="model"):
            h, gates, topw, tope = moe_route(p, cfg, x)
            if _CHOICES is not None:
                topw, tope = _CHOICES.take(gates, topw, tope, cfg.moe_renorm)
            K = tope.shape[-1]
            route = moe_dispatch(tope.reshape(B * S, K),
                                 topw.reshape(B * S, K), cfg.n_experts)
        out = ops.moe_experts(h.reshape(B * S, d), route, p["wg"], p["wu"],
                              p["wd"], impl=cfg.attn_impl)
        if "shared" in p:
            sh = p["shared"]
            out = out + ops.mlp(x, p["ln"], sh["wg"], sh["wu"], sh["wd"],
                                eps=cfg.norm_eps, impl=cfg.attn_impl
                                ).reshape(B * S, d).to(out.dtype)
        y = x + out.reshape(B, S, d).to(x.dtype)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def decode_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device: torch.device) -> dict:
    """An empty per-layer KV cache (stacked over layers elsewhere).

    MLA: {"c_kv" (batch, max_len, r), "k_rope" (batch, max_len, kr)}, the
    two column halves of one (batch, max_len, r + kr) buffer, so the
    absorbed decode reads [c_kv ; k_rope] as one strided tensor, each row
    once, without a copy.  Otherwise {"k", "v"} (batch, Hkv, max_len, D),
    Hkv raised to ``kv_repeat_to`` where that is larger.
    """
    if cfg.use_mla:
        r = cfg.kv_lora_rank
        rows = torch.zeros((batch, max_len, r + cfg.rope_head_dim),
                           dtype=dtype, device=device)
        return {"c_kv": rows[..., :r], "k_rope": rows[..., r:]}
    shape = (batch, max(cfg.n_kv_heads, cfg.kv_repeat_to), max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------------
# Mamba2 (SSD) block
# ----------------------------------------------------------------------
def mamba2_defs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "ln": ParamDef((d,), ("embed",), "ones"),
        "in_proj": ParamDef((d, 2 * di + 2 * g * n + H),
                            ("embed", "ssm_inner")),
        "conv_w": ParamDef((cfg.conv_width, conv_ch), (None, "ssm_inner"),
                           scale=0.5),
        "conv_b": ParamDef((conv_ch,), ("ssm_inner",), "zeros"),
        "A": ParamDef((H,), (None,), "ssm_a"),
        "D": ParamDef((H,), (None,), "ones"),
        "dt_bias": ParamDef((H,), (None,), "dt_bias"),
        "out_ln": ParamDef((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv by shifted adds.  x: (B, S, C); w: (W, C).

    state: (B, W-1, C) trailing context from the previous segment, taken
    in x's type.  Returns (y, new_state), new_state in x's type.
    """
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+W-1, C)
    S = x.shape[1]
    y = b
    for i in range(W):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return y, new_state


def _ssm_in(p: dict, cfg: ModelConfig, x: torch.Tensor,
            conv_state: torch.Tensor | None):
    """The block's input half: norm, in_proj, the causal conv and the
    split into z, xs, B, C and the softplus'ed float32 dt."""
    B, S, _ = x.shape
    di, g, n, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt_raw = zxbcdt[..., -H:]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = torch.nn.functional.silu(xbc)
    xs = xbc[..., :di].reshape(B, S, H, P)
    Bm = xbc[..., di:di + g * n].reshape(B, S, g, n)
    Cm = xbc[..., di + g * n:].reshape(B, S, g, n)
    dt = torch.nn.functional.softplus(dt_raw.to(torch.float32)
                                      + p["dt_bias"].to(torch.float32))
    return z, xs, Bm, Cm, dt, new_conv


def _ssm_out(p: dict, cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    y = y.reshape(*x.shape[:2], cfg.d_inner)
    y = rmsnorm(y * torch.nn.functional.silu(z), p["out_ln"], cfg.norm_eps)
    return x + y @ p["out_proj"]


def mamba2_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: torch.Tensor | None = None,
                 ssm_state: torch.Tensor | None = None,
                 return_state: bool = False):
    """Mamba2 block (SSD).  x: (B, S, d) -> (B, S, d).

    The scan goes through :func:`ops.ssd` (the ``ssd_scan`` kernel on the
    card).  With ``return_state`` also returns the conv state (B, W-1,
    conv_ch) and the float32 SSM state (B, H, P, N) after the segment.
    """
    z, xs, Bm, Cm, dt, new_conv = _ssm_in(p, cfg, x, conv_state)
    y, final_state = ops.ssd(xs, dt, p["A"], Bm, Cm, chunk=cfg.ssm_chunk,
                             impl=cfg.attn_impl, init_state=ssm_state)
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    out = _ssm_out(p, cfg, x, y, z)
    if return_state:
        return out, new_conv, final_state
    return out


def mamba2_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Single-token recurrent step.  x: (B, 1, d).

    conv_state: (B, W-1, conv_ch), in any float type (read in x's type);
    ssm_state: (B, H, P, N) float32.  Both are updated IN PLACE, as
    ``attention_block`` writes the KV cache, where the reference returns
    new arrays; returns (x + out, conv_state, ssm_state).  Plain PyTorch:
    the reference composes this step in XLA, not in a Pallas kernel.
    """
    B = x.shape[0]
    g, H = cfg.ssm_groups, cfg.ssm_heads
    z, xs, Bm, Cm, dt, new_conv = _ssm_in(p, cfg, x, conv_state)
    xs, Bm, Cm, dt = xs[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0]
    rep = H // g
    if rep > 1:            # repeat_interleave by expand: no host wait
        n = Bm.shape[-1]
        Bm = Bm[:, :, None].expand(B, g, rep, n).reshape(B, H, n)
        Cm = Cm[:, :, None].expand(B, g, rep, n).reshape(B, H, n)
    f32 = torch.float32
    dec = torch.exp(dt * p["A"].to(f32))                  # (B, H)
    upd = torch.einsum("bhn,bhp,bh->bhpn", Bm.to(f32), xs.to(f32), dt)
    ssm_state.mul_(dec[..., None, None]).add_(upd)
    y = torch.einsum("bhn,bhpn->bhp", Cm.to(f32), ssm_state)
    y = y.to(x.dtype) + xs * p["D"].to(x.dtype)[None, :, None]
    conv_state.copy_(new_conv)
    return _ssm_out(p, cfg, x, y[:, None], z), conv_state, ssm_state
