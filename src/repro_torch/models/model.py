"""The dense, MoE, MLA, SSM and hybrid LMs: parameters, cache, prefill
and decode (the port of ``repro.models.model``).

Public API (plain functions over dicts of tensors):
  param_defs(cfg)                          declarative parameter tree
  init(cfg, rng, device)                   parameter values
  from_jax_params(cfg, params_np, device)  the reference's values, carried over
  init_cache(cfg, batch, max_len, dtype, device)   decode cache
  prefill(params, cfg, tokens, cache)      fill the cache, last-position logits
  decode_step(params, cfg, token, cache)   one token for every sequence

The parameters keep the reference's layout: every block parameter is
stacked on a leading layer axis, and the layers run as a Python loop
over it (the reference's ``_scan_or_loop`` unrolled, so the hybrid's
shared-attention sites are static).  The serving paths of the ``dense``
(with MLA attention: minicpm3), ``moe`` (granite-moe, qwen3-moe), ``ssm``
(mamba2) and ``hybrid`` (zamba2) families are ported; the encoder
(``encdec``) and vision (``vlm``) families, ``kv_repeat_to`` and the
training path (``loss_fn``) raise
:class:`~repro_torch.device.NotPortedError`.  Caches are updated in
place.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import NotPortedError, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = ["param_defs", "init", "from_jax_params", "loss_fn",
           "init_cache", "prefill", "decode_step", "torch_dtype",
           "check_ported"]


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_ported(cfg: ModelConfig) -> None:
    """Raise :class:`NotPortedError` for what this slice does not run."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotPortedError(f"{cfg.name}: the {cfg.family!r} family is not "
                             f"ported yet (the port serves 'dense', 'moe', "
                             f"'ssm' and 'hybrid')")
    if cfg.kv_repeat_to > 0:
        raise NotPortedError(f"{cfg.name}: kv_repeat_to is not ported yet")


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def _stack(defs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every ParamDef in a tree."""
    if isinstance(defs, L.ParamDef):
        return L.ParamDef((n,) + defs.shape, ("layers",) + defs.axes,
                          defs.init, defs.scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def _block_defs(cfg: ModelConfig) -> dict:
    if cfg.family in ("ssm", "hybrid"):
        return {"mamba": L.mamba2_defs(cfg)}
    attn = L.mla_defs(cfg) if cfg.use_mla else L.attn_defs(cfg)
    mlp = L.moe_defs(cfg) if cfg.n_experts else L.mlp_defs(cfg)
    return {"attn": attn, "mlp": mlp}


def param_defs(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    defs: dict[str, Any] = {
        "embed": L.ParamDef((V, d), ("vocab", "embed"), scale=0.02),
        "final_ln": L.ParamDef((d,), ("embed",), "ones"),
        "blocks": _stack(_block_defs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((d, V), ("embed", "vocab"))
    if cfg.family == "hybrid":
        defs["shared_attn"] = L.attn_defs(cfg)
        defs["shared_mlp"] = L.mlp_defs(cfg)
    return defs


def init(cfg: ModelConfig, rng: int | torch.Generator = 0,
         device=None) -> dict:
    """Random parameters by the declared laws.  ``rng`` is a seed or a
    ``torch.Generator`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    defs = param_defs(cfg)
    if isinstance(rng, torch.Generator):
        gen = rng
        if gen.device.type != dev.type:
            raise ValueError(f"the generator lives on {gen.device}, the "
                             f"parameters on {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(rng))
    return L.init_tree(defs, gen, torch_dtype(cfg.dtype), dev)


def _from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, by name
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(cfg: ModelConfig, params_np: Mapping,
                    device=None) -> dict:
    """The reference's parameter tree (``jax.tree.map(np.asarray,
    repro.models.model.init(...))``) as the port's, bit for bit and in
    each leaf's own type (the SSM's A and dt_bias stay float32).

    bfloat16 arrays are read through an int16 view by their dtype's name,
    so this needs neither JAX nor ``ml_dtypes``.
    """
    dev = resolve_device(device)
    defs = param_defs(cfg)

    def carry(d, p, path):
        if isinstance(d, L.ParamDef):
            t = _from_numpy(p, dev)
            if tuple(t.shape) != d.shape:
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(t.shape)}, expected {d.shape}")
            return t
        if set(d) != set(p):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(p)}, expected {sorted(d)}")
        return {k: carry(d[k], p[k], path + (k,)) for k in d}

    return carry(defs, params_np, ())


# ----------------------------------------------------------------------
# the layer loop
# ----------------------------------------------------------------------
def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _dense_block(p, cfg, x, pos, cache=None, idx=None, causal=True):
    """One decoder block of the dense and moe families: attention (MLA
    where ``use_mla``), then the MLP (MoE where ``n_experts``).  Returns
    (x, cache, aux), aux the MoE's load-balance loss (0 without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.use_mla:
        x, cache = L.mla_attention_block(p["attn"], cfg, x, pos, cache, idx)
    else:
        x, cache = L.attention_block(p["attn"], cfg, x, pos, cache, idx,
                                     causal=causal)
    if cfg.n_experts:
        x, aux = L.moe_block(p["mlp"], cfg, x)
    else:
        x = L.mlp_block(p["mlp"], cfg, x)
    return x, cache, aux


def _run_blocks(params, cfg, x, pos, cache=None, index=None,
                decode=False):
    """The layer loop; serving drops the blocks' aux, as the reference's
    prefill and decode do."""
    if cfg.family in ("ssm", "hybrid"):
        return _iterate_ssm(params, cfg, x, pos, cache, index, decode)
    for i in range(cfg.n_layers):
        cache_l = None if cache is None else _layer(cache["attn"], i)
        x, _, _ = _dense_block(_layer(params["blocks"], i), cfg, x, pos,
                               cache_l, index)
    return x


def _maybe_shared_attn(cfg, params, x, pos, i, attn_cache, cache_index):
    """The hybrid's shared attention + MLP, at layers ``i`` with
    ``i % attn_every == attn_every - 1``; site ``i // attn_every`` of
    the cache."""
    k = cfg.attn_every
    if i % k != k - 1:
        return x
    x, _ = L.attention_block(params["shared_attn"], cfg, x, pos,
                             _layer(attn_cache, i // k), cache_index)
    return L.mlp_block(params["shared_mlp"], cfg, x)


def _iterate_ssm(params, cfg, x, pos, cache, cache_index, decode):
    """The layer loop of the ssm and hybrid families.  A decode step
    takes the recurrent step, which updates each layer's conv and SSM
    state in place; a prompt runs the chunked scan from zero state and
    writes the states it ends with into the cache."""
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)["mamba"]
        if decode:
            x, _, _ = L.mamba2_decode_step(p, cfg, x, cache["conv"][i],
                                           cache["ssm"][i])
        else:
            x, conv, ssm = L.mamba2_block(p, cfg, x, return_state=True)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
        if cfg.family == "hybrid":
            x = _maybe_shared_attn(cfg, params, x, pos, i, cache["attn"],
                                   cache_index)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _check_inputs(cfg, enc_embeds, extra_embeds):
    check_ported(cfg)
    if enc_embeds is not None or extra_embeds is not None:
        raise NotPortedError("encoder (enc_embeds) and vision "
                             "(extra_embeds) inputs are not ported yet")


def loss_fn(params, cfg, batch):
    """The training path comes with a later slice."""
    raise NotPortedError("loss_fn (the training path) is not ported yet")


# ----------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """The decode cache; every leaf but ``index`` has the batch on axis 1.

    dense and moe: {"index", "attn": {"k", "v"} (layers, batch, Hkv,
    max_len, D)}, or with MLA {"c_kv" (layers, batch, max_len, r),
    "k_rope" (layers, batch, max_len, kr)} (views of one buffer, see
    :func:`L.decode_attn_cache`);
    ssm: {"index", "conv" (layers, batch, W-1, conv_ch) in ``dtype``,
    "ssm" (layers, batch, H, P, N) float32}; hybrid: the ssm cache plus
    "attn" for its ``n_layers // attn_every`` shared-attention sites.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    cache: dict[str, Any] = {
        "index": torch.zeros((), dtype=torch.int32, device=dev)}
    n_attn = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache["conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
            device=dev)
        cache["ssm"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=torch.float32, device=dev)
        if cfg.family == "ssm":
            return cache
        n_attn = cfg.n_layers // cfg.attn_every
    per_layer = L.decode_attn_cache(cfg, n_attn * batch, max_len, dtype,
                                    dev)
    cache["attn"] = {k: c.view(n_attn, batch, *c.shape[1:])
                     for k, c in per_layer.items()}
    return cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, enc_embeds=None, extra_embeds=None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling the cache (in place).
    Returns (last-position logits (B, V) float32, cache)."""
    _check_inputs(cfg, enc_embeds, extra_embeds)
    x = L.embed_tokens(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    x = _run_blocks(params, cfg, x, pos, cache, 0)
    cache = {**cache, "index": torch.tensor(S, dtype=torch.int32,
                                            device=x.device)}
    x = L.rmsnorm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    return L.unembed(x, _head(params, cfg))[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  token: (B,) int.  ``cache["index"]``
    is a scalar (lock-step) or a (B,) vector of per-slot lengths
    (continuous batching).  Returns (logits (B, V) float32, cache)."""
    check_ported(cfg)
    idx = cache["index"]
    x = L.embed_tokens(params["embed"], token[:, None]).to(
        torch_dtype(cfg.dtype))
    pos = idx[None] if idx.dim() == 0 else idx[:, None]
    x = _run_blocks(params, cfg, x, pos, cache, idx, decode=True)
    cache = {**cache, "index": idx + 1}
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return L.unembed(x, _head(params, cfg))[:, 0], cache
