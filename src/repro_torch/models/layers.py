"""Model building blocks for the dense, SSM and hybrid families (the
port of ``repro.models.layers``).

Parameters are declared with :class:`ParamDef` (shape, logical axes,
init law) and made by :func:`init_tree` from one ``torch.Generator`` on
the target device.  The blocks are plain functions on tensors; the LM
kernels are reached through :mod:`repro_torch.kernels.ops` only.  The
decode path (``S == 1``) builds no device tensor from host data and
reads nothing back to the host, so one CUDA graph can capture a whole
decode step (:mod:`repro_torch.runtime.compiled_step`).

Not here: the reference's ``shard_act`` / ``activation_rules`` (a no-op
without a mesh, and the port has no mesh yet), MLA, MoE and the chunked
XLA attention, which come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import NotPortedError
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

__all__ = ["ParamDef", "init_tree", "rmsnorm", "rope", "embed_tokens",
           "unembed", "attn_defs", "attention_block", "mlp_defs",
           "mlp_block", "decode_attn_cache", "mamba2_defs", "mamba2_block",
           "mamba2_decode_step"]


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


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half form.  x: (..., S, H, D); pos: (S,)
    for a shared position run, or (B, 1) per sequence at decode."""
    D = x.shape[-1]
    half = D // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python base: no host-to-device copy, so a CUDA graph can capture it
    freqs = torch.pow(float(theta), exps)
    ang = pos[..., None].to(torch.float32) * freqs        # (..., S, half)
    ang = ang[..., None, :]                               # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in float32, as the reference computes them."""
    return x.to(torch.float32) @ head.to(torch.float32)


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
                    causal: bool = True) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm attention with residual.  x: (B, S, d).

    cache: {"k", "v"} (B, Hkv, Smax, D), written at ``cache_index`` (a
    scalar or a (B,) vector of per-slot positions) IN PLACE, where the
    reference returns new arrays.  With S == 1 the query attends to the
    cache under the mask ``arange(Smax) <= index``; otherwise to the
    fresh keys and values (a prefill starts at 0).
    Returns (x + attn_out, cache).
    """
    if cfg.attn_chunk:
        raise NotPortedError("attn_chunk > 0 (the chunked XLA attention "
                             "scan) is not ported yet")
    if cfg.kv_repeat_to > cfg.n_kv_heads:
        raise NotPortedError("kv_repeat_to (KV heads replicated for a mesh)"
                             " is not ported yet")
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(x, p["ln"], cfg.norm_eps)

    q = h @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = rope(q.reshape(B, S, Hq, hd), pos, cfg.rope_theta)

    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = rope(k.reshape(B, S, Hkv, hd), pos, cfg.rope_theta).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)      # (B, Hkv, S, D)

    if cache is not None:
        _write_cache(cache["k"], k, cache_index)
        _write_cache(cache["v"], v, cache_index)
        if S == 1:                 # decode attends against the cache;
            k, v = cache["k"], cache["v"]   # prefill against the fresh
                                            # projections (from 0)

    qh = q.transpose(1, 2)                            # (B, Hq, S, D)
    if S == 1:
        Smax = k.shape[2]
        idx = cache_index
        if not isinstance(idx, torch.Tensor):
            idx = torch.tensor(idx, device=x.device)
        idxb = idx[:, None] if idx.dim() == 1 else idx
        keep = torch.arange(Smax, device=x.device)[None, :] <= idxb
        bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        bias = bias.expand(B, Smax)
        out = ops.decode_attention(qh[:, :, 0], k, v, bias=bias,
                                   impl=cfg.attn_impl)      # (B, Hq, D)
        out = out.reshape(B, 1, Hq * hd)
    else:
        out = ops.attention(qh, k, v, bias=None, causal=causal,
                            impl=cfg.attn_impl)
        out = out.transpose(1, 2).reshape(B, S, Hq * hd)
    return x + (out @ p["wo"]).to(x.dtype), cache


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
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


def decode_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device: torch.device) -> dict:
    """An empty per-layer KV cache (stacked over layers elsewhere)."""
    if cfg.use_mla:
        raise NotPortedError("the MLA latent cache is not ported yet")
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
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
