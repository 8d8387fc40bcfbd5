"""The LMs of every family: parameters, cache, prefill and decode (the
port of ``repro.models.model``).

Public API (plain functions over dicts of tensors):
  param_defs(cfg)                          declarative parameter tree
  param_axes(cfg)                          logical-sharding tree (same structure)
  init(cfg, rng, device)                   parameter values
  from_jax_params(cfg, params_np, device)  the reference's values, carried over
  init_cache(cfg, batch, max_len, dtype, device)   decode cache
  CACHE_AXES, cache_axes(cache), cache_slot(cache, i)   its layout, a slot
  prefill(params, cfg, tokens, cache, enc_embeds=, extra_embeds=)
                                           fill the cache, last-position logits
  decode_step(params, cfg, token, cache)   one token for every sequence
  forward(params, cfg, tokens, extra_embeds=, enc_embeds=)
                                           logits, aux (training / scoring)
  loss_fn(params, cfg, batch)              scalar + metrics
  loss_sums(params, cfg, batch)            its parts: cross-entropy sum, count, aux
  from_jax_train_state(cfg, state_np, device) / to_numpy(tree)
                                           train states across the packages

The parameters keep the reference's layout: every block parameter is
stacked on a leading layer axis, and the layers run as a Python loop
over it (the reference's ``_scan_or_loop`` unrolled, so the hybrid's
shared-attention sites are static).  The serving paths of every family
are ported: ``dense`` (with MLA attention: minicpm3), ``moe``
(granite-moe, qwen3-moe), ``ssm`` (mamba2), ``hybrid`` (zamba2),
``encdec`` (whisper: a non-causal encoder over ``enc_embeds``, then
cross-attention in every decoder block to K and V projected from its
output, which the cache keeps as ``enc_out``) and ``vlm`` (internvl2:
``extra_embeds`` prepended to the prompt's embeddings).  Caches are
updated in place.

Training (``forward``, ``loss_fn``) runs every family without a cache,
each layer under ``cfg.remat`` (:func:`_remat`): ``"none"``; ``"full"``,
``torch.utils.checkpoint`` per layer; ``"dots"``, the same with the
outputs of matrix products without a batch dim (``aten.mm``) saved, as
the reference's ``dots_with_no_batch_dims_saveable``.  The stacked block
parameters are unbound once per forward, so the backward stacks each
leaf's gradient in one op.
"""
from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.device import resolve_device
from repro_torch.kernels.autograd import needs_grad
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = ["param_defs", "param_axes", "init", "from_jax_params",
           "from_jax_train_state", "to_numpy", "forward", "loss_fn",
           "loss_sums", "CACHE_AXES", "cache_axes", "cache_slot",
           "init_cache", "prefill",
           "decode_step", "torch_dtype", "L_cross_kv"]


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def _stack(defs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every ParamDef in a tree."""
    if isinstance(defs, L.ParamDef):
        return L.ParamDef((n,) + defs.shape, ("layers",) + defs.axes,
                          defs.init, defs.scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def _block_defs(cfg: ModelConfig, dense: bool = False) -> dict:
    """One layer's leaves; ``dense``: a leading layer of a MoE config,
    whose MLP is a SwiGLU of width ``dense_d_ff``."""
    if cfg.family in ("ssm", "hybrid"):
        return {"mamba": L.mamba2_defs(cfg)}
    attn = L.mla_defs(cfg) if cfg.use_mla else L.attn_defs(cfg)
    if dense:
        return {"attn": attn, "mlp": L.mlp_defs(cfg, cfg.dense_d_ff)}
    mlp = L.moe_defs(cfg) if cfg.n_experts else L.mlp_defs(cfg)
    return {"attn": attn, "mlp": mlp}


def param_defs(cfg: ModelConfig) -> dict:
    """The parameter tree.  A config with ``first_dense_layers`` k keeps
    its leading dense layers in ``dense_blocks`` (stacked on k) and the
    other ``n_layers - k`` in ``blocks``; layer i < k is
    ``dense_blocks[i]``, layer i >= k ``blocks[i - k]``."""
    d, V = cfg.d_model, cfg.vocab_size
    k = cfg.first_dense_layers
    defs: dict[str, Any] = {
        "embed": L.ParamDef((V, d), ("vocab", "embed"), scale=0.02),
        "final_ln": L.ParamDef((d,), ("embed",), "ones"),
        "blocks": _stack(_block_defs(cfg), cfg.n_layers - k),
    }
    if k:
        defs["dense_blocks"] = _stack(_block_defs(cfg, dense=True), k)
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((d, V), ("embed", "vocab"))
    if cfg.family == "hybrid":
        defs["shared_attn"] = L.attn_defs(cfg)
        defs["shared_mlp"] = L.mlp_defs(cfg)
    if cfg.family == "encdec":
        enc = {"attn": L.attn_defs(cfg), "mlp": L.mlp_defs(cfg)}
        defs["enc_blocks"] = _stack(enc, cfg.n_enc_layers)
        defs["enc_final_ln"] = L.ParamDef((d,), ("embed",), "ones")
        defs["cross_blocks"] = _stack(L.attn_defs(cfg), cfg.n_layers)
    return defs


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter (``ParamDef.axes``), in the
    tree of :func:`param_defs`."""
    def walk(d):
        if isinstance(d, L.ParamDef):
            return d.axes
        return {k: walk(v) for k, v in d.items()}
    return walk(param_defs(cfg))


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
    return _carry(param_defs(cfg), params_np, resolve_device(device), ())


def _carry(d, p, dev: torch.device, path: tuple) -> Any:
    """``p`` (numpy) as tensors on ``dev``, checked against the ParamDef
    tree ``d``."""
    if isinstance(d, L.ParamDef):
        t = _from_numpy(p, dev)
        if tuple(t.shape) != d.shape:
            raise ValueError(f"{'/'.join(path)}: shape "
                             f"{tuple(t.shape)}, expected {d.shape}")
        return t
    if set(d) != set(p):
        raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                         f"{sorted(p)}, expected {sorted(d)}")
    return {k: _carry(d[k], p[k], dev, path + (k,)) for k in d}


def from_jax_train_state(cfg: ModelConfig, state_np: Mapping,
                         device=None) -> dict:
    """The reference's train state ``{"params", "opt": {"master", "m",
    "v", "step"}, "ef"?}`` as numpy (``jax.tree.map(np.asarray, state)``)
    as the port's (:mod:`repro_torch.optim.adamw`): the same tree, bit
    for bit, ``step`` an int32 scalar."""
    dev = resolve_device(device)
    defs = param_defs(cfg)
    opt = state_np["opt"]
    state = {"params": _carry(defs, state_np["params"], dev, ("params",)),
             "opt": {k: _carry(defs, opt[k], dev, ("opt", k))
                     for k in ("master", "m", "v")}}
    state["opt"]["step"] = torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32, device=dev)
    if "ef" in state_np:
        state["ef"] = _carry(defs, state_np["ef"], dev, ("ef",))
    return state


def to_numpy(tree: Any) -> Any:
    """A tree of tensors as numpy on the host: bfloat16 as float32 (exact),
    every other type as it is."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {k: to_numpy(v) for k, v in tree.items()}


# ----------------------------------------------------------------------
# the layer loop
# ----------------------------------------------------------------------
def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _block_params(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s leaves (:func:`param_defs`: the leading dense
    layers first)."""
    k = cfg.first_dense_layers
    if i < k:
        return _layer(params["dense_blocks"], i)
    return _layer(params["blocks"], i - k)


def _dense_block(p, cfg, x, pos, cache=None, idx=None, causal=True):
    """One decoder block of the dense and moe families: attention (MLA
    where ``use_mla``), then the MLP (MoE where ``n_experts`` and the
    layer has a router).  Returns (x, cache, aux), aux the MoE's
    load-balance loss (0 without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.use_mla:
        x, cache = L.mla_attention_block(p["attn"], cfg, x, pos, cache, idx)
    else:
        x, cache = L.attention_block(p["attn"], cfg, x, pos, cache, idx,
                                     causal=causal)
    if cfg.n_experts and "router" in p["mlp"]:
        x, aux = L.moe_block(p["mlp"], cfg, x)
    else:
        x = L.mlp_block(p["mlp"], cfg, x)
    return x, cache, aux


def _run_blocks(params, cfg, x, pos, cache=None, index=None,
                decode=False, enc_out=None):
    """The layer loop; serving drops the blocks' aux, as the reference's
    prefill and decode do.  With ``enc_out`` (encdec) each decoder block
    is followed by its cross-attention block."""
    if cfg.family in ("ssm", "hybrid"):
        return _iterate_ssm(params, cfg, x, pos, cache, index, decode)
    for i in range(cfg.n_layers):
        cache_l = None if cache is None else _layer(cache["attn"], i)
        x, _, _ = _dense_block(_block_params(params, cfg, i), cfg, x, pos,
                               cache_l, index)
        if enc_out is not None:
            cross = _layer(params["cross_blocks"], i)
            x, _ = L.attention_block(cross, cfg, x, pos,
                                     cross_kv=L_cross_kv(cross, cfg, enc_out),
                                     causal=False)
    return x


def _encode(params, cfg, enc_embeds):
    """whisper's encoder: non-causal dense blocks over the frames, each
    under ``cfg.remat`` when it trains, then the final norm.  (B, Senc,
    d) in the config's type."""
    x = enc_embeds.to(torch_dtype(cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device)
    blocks = _unbind(params["enc_blocks"])
    run = _remat(lambda x, i: _dense_block(blocks[i], cfg, x, pos,
                                           causal=False)[0],
                 cfg, _trains(params, x))
    for i in range(cfg.n_enc_layers):
        x = run(x, i)
    return L.rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def L_cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """Project the encoder output to one cross-attention block's K and V,
    (B, Hkv, Senc, D) each, not roped.  The product takes the promoted
    type of ``enc_out`` and the weights, as ``jnp.matmul`` does: float32
    from a float32 cache under bf16 weights."""
    B, Se, _ = enc_out.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    dt = torch.promote_types(enc_out.dtype, p["wk"].dtype)
    k = (enc_out.to(dt) @ p["wk"].to(dt)).reshape(B, Se, Hkv, hd)
    v = (enc_out.to(dt) @ p["wv"].to(dt)).reshape(B, Se, Hkv, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _maybe_shared_attn(cfg, params, x, pos, i, attn_cache=None,
                       cache_index=None):
    """The hybrid's shared attention + MLP, at layers ``i`` with
    ``i % attn_every == attn_every - 1``; site ``i // attn_every`` of
    the cache (none on the training forward)."""
    k = cfg.attn_every
    if i % k != k - 1:
        return x
    site = None if attn_cache is None else _layer(attn_cache, i // k)
    x, _ = L.attention_block(params["shared_attn"], cfg, x, pos, site,
                             cache_index)
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


# ----------------------------------------------------------------------
# forward (training / scoring; no cache)
# ----------------------------------------------------------------------
def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products without a batch dim (the
    reference's ``dots_with_no_batch_dims_saveable``); recompute the
    rest, the kernels' forwards among them."""
    if op is torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _trains(params: dict, x: torch.Tensor) -> bool:
    """Whether a forward over ``params`` from ``x`` is recorded for a
    backward: grad mode on, and ``x`` or a parameter requires a
    gradient."""
    return needs_grad(x, *tree_leaves(params))


def _remat(fn, cfg: ModelConfig, trains: bool):
    """``fn`` (one layer) under ``cfg.remat``: ``"none"`` as it is;
    ``"full"`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``); ``"dots"`` the same, with the products
    of :func:`_dots_policy` saved.  Unless it ``trains``
    (:func:`_trains`), ``fn``: serving runs no checkpoint.

    Inside an ``expert_choices`` block the recompute repeats the
    layer's first pass (:func:`L.recomputing`): a replay stays aligned
    and nothing is recorded twice.  (A checkpoint with a policy insists
    on the same operations in the recompute.)"""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not trains:
        return fn
    kw: dict[str, Any] = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        choices = L.active_choices()
        if choices is None:
            return _ckpt.checkpoint(fn, *args, **kw)
        start, taken = len(choices.chosen), []

        def body(*a):
            if taken:                  # the recompute
                replay = (None if choices.replay is None
                          else choices.replay[start:start + taken[0]])
                with L.recomputing(replay):
                    return fn(*a)
            out = fn(*a)
            taken.append(len(choices.chosen) - start)
            return out
        return _ckpt.checkpoint(body, *args, **kw)
    return run


def _unbind(tree: Any) -> list:
    """A tree of stacked (layers, ...) tensors as one tree per layer."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    per = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _train_blocks(params, cfg, x, pos, enc_out=None):
    """The training forward's layer loop, no cache, each layer under
    ``cfg.remat``.  Returns (x, aux): aux the mean of the layers'
    load-balance losses (0 for the ssm and hybrid families), as the
    reference's ``_run_blocks``."""
    blocks = _unbind(params["blocks"])
    if cfg.first_dense_layers:
        blocks = _unbind(params["dense_blocks"]) + blocks
    cross = (_unbind(params["cross_blocks"]) if cfg.family == "encdec"
             else None)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, i):
        if cfg.family in ("ssm", "hybrid"):
            x = L.mamba2_block(blocks[i]["mamba"], cfg, x)
            if cfg.family == "hybrid":
                x = _maybe_shared_attn(cfg, params, x, pos, i)
            return x, zero
        x, _, aux = _dense_block(blocks[i], cfg, x, pos)
        if cross is not None:
            x, _ = L.attention_block(
                cross[i], cfg, x, pos,
                cross_kv=L_cross_kv(cross[i], cfg, enc_out), causal=False)
        return x, aux

    run = _remat(layer, cfg, _trains(params, x))
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = run(x, i)
        auxs.append(aux)
    if cfg.family in ("ssm", "hybrid") or not auxs:
        return x, zero
    return x, torch.stack(auxs).mean()


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text).  extra_embeds: (B, S_vis, d), a vision prefix
    (vlm).  enc_embeds: (B, S_enc, d), the encoder's frames (encdec).
    Returns (logits (B, S_total, V) float32, aux float32)."""
    x = L.embed_tokens(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             f"enc_embeds, the encoder's frames")
        enc_out = _encode(params, cfg, enc_embeds)
    x, aux = _train_blocks(params, cfg, x, pos, enc_out=enc_out)
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return L.unembed(x, _head(params, cfg)), aux


def loss_sums(params: dict, cfg: ModelConfig, batch: Mapping
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The parts of :func:`loss_fn`: (the cross entropy summed over the
    labelled positions, their count, aux), all float32 scalars.  A
    sharded step adds the data shards' sums and counts before dividing
    (:mod:`repro_torch.runtime.steps`)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          extra_embeds=batch.get("extra_embeds"),
                          enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:     # vlm: drop the prefix
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    mask = (labels >= 0).to(torch.float32)
    ce = L.softmax_cross_entropy(logits, labels.clamp_min(0))
    return (ce * mask).sum(), mask.sum(), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: Mapping
            ) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, S), labels (B, S) (-1 = ignore), optionally
    extra_embeds / enc_embeds.  Returns (total, {"loss", "aux",
    "tokens"}): the mean cross entropy over the labelled positions (a
    vlm's prefix dropped), plus ``router_aux_loss`` x aux."""
    ce_sum, count, aux = loss_sums(params, cfg, batch)
    loss = ce_sum / count.clamp_min(1.0)
    total = loss + cfg.router_aux_loss * aux
    return total, {"loss": loss, "aux": aux, "tokens": count}


# ----------------------------------------------------------------------
# serving: the cache's layout / prefill / decode
# ----------------------------------------------------------------------
_KV = ("layers", "batch", "kv_heads", "seq", None)
_LATENT = ("layers", "batch", "seq", None)

#: The logical axes of every decode-cache leaf, in the tree of
#: :func:`init_cache` and the reference's vocabulary: ``batch`` is the
#: slot, ``seq`` the cache length (``enc_out``'s: the encoder's frames).
#: ``index`` has none: a scalar, or a (batch,) vector of per-slot lengths
#: once a batcher decodes.
CACHE_AXES = {
    "attn": {"k": _KV, "v": _KV, "c_kv": _LATENT, "k_rope": _LATENT},
    "conv": ("layers", "batch", None, "ssm_inner"),
    "ssm": ("layers", "batch", "ssm_inner", None, None),
    "enc_out": ("batch", "seq", None),
}


def cache_axes(cache: dict) -> dict:
    """The :data:`CACHE_AXES` of ``cache``'s leaves (of any type), in its
    tree without ``index``."""
    return {k: ({n: CACHE_AXES[k][n] for n in v} if isinstance(v, dict)
                else CACHE_AXES[k])
            for k, v in cache.items() if k != "index"}


def cache_slot(cache: dict, i: int) -> dict:
    """Slot ``i`` of ``cache`` as a B = 1 cache of views, without
    ``index`` (a prefill returns its own): each leaf narrowed on its
    ``batch`` axis, so MLA's two latent leaves stay views of their one
    buffer.  A prefill into it writes the slot in place."""
    return tree_map(lambda t, axes: t.narrow(axes.index("batch"), i, 1),
                    {k: v for k, v in cache.items() if k != "index"},
                    cache_axes(cache))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """The decode cache, each leaf laid out as :data:`CACHE_AXES` says.

    dense, moe, encdec and vlm: {"index", "attn": {"k", "v"} (layers,
    batch, Hkv, max_len, D)} (Hkv raised to ``kv_repeat_to`` where that
    is larger), or with MLA {"c_kv" (layers, batch, max_len, r),
    "k_rope" (layers, batch, max_len, kr)} (views of one buffer, see
    :func:`L.decode_attn_cache`);
    ssm: {"index", "conv" (layers, batch, W-1, conv_ch) in ``dtype``,
    "ssm" (layers, batch, H, P, N) float32}; hybrid: the ssm cache plus
    "attn" for its ``n_layers // attn_every`` shared-attention sites;
    encdec: also "enc_out" (batch, n_frontend_tokens or 1500, d), the
    encoder's output, which a prefill writes and decode projects.
    """
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
    if cfg.family == "encdec":
        cache["enc_out"] = torch.zeros(
            (batch, cfg.n_frontend_tokens or 1500, cfg.d_model), dtype=dtype,
            device=dev)
    return cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, enc_embeds: torch.Tensor | None = None,
            extra_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling the cache (in place).

    extra_embeds: (B, S_vis, d), a vision prefix put before the prompt's
    embeddings (the cache index is then S_vis + S).  enc_embeds: (B,
    Senc, d), the encoder's frames, which an encdec model needs; the
    encoder's output is written into ``cache["enc_out"]`` (of the same
    shape).  Returns (last-position logits (B, V) float32, cache)."""
    x = L.embed_tokens(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    enc_out = None
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                             f"enc_embeds, the encoder's frames (B, frames, "
                             f"d_model)")
        enc_out = _encode(params, cfg, enc_embeds)
        if cache["enc_out"].shape != enc_out.shape:
            raise ValueError(f"{cfg.name}: enc_embeds gives an encoder output "
                             f"{tuple(enc_out.shape)}; the cache holds "
                             f"{tuple(cache['enc_out'].shape)}")
        cache["enc_out"].copy_(enc_out)
    x = _run_blocks(params, cfg, x, pos, cache, 0, enc_out=enc_out)
    cache = {**cache, "index": torch.tensor(S, dtype=torch.int32,
                                            device=x.device)}
    x = L.rmsnorm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    return L.unembed(x, _head(params, cfg))[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  token: (B,) int.  ``cache["index"]``
    is a scalar (lock-step) or a (B,) vector of per-slot lengths
    (continuous batching).  An encdec model projects ``cache["enc_out"]``
    to each cross-attention block's K and V every step, as the reference
    does.  Returns (logits (B, V) float32, cache)."""
    idx = cache["index"]
    x = L.embed_tokens(params["embed"], token[:, None]).to(
        torch_dtype(cfg.dtype))
    pos = idx[None] if idx.dim() == 0 else idx[:, None]
    x = _run_blocks(params, cfg, x, pos, cache, idx, decode=True,
                    enc_out=cache.get("enc_out"))
    cache = {**cache, "index": idx + 1}
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return L.unembed(x, _head(params, cfg))[:, 0], cache
