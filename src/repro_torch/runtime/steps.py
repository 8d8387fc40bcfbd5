"""Step-function builders: train, prefill and decode (the port of
``repro.runtime.steps``).

A step here is a plain function, as in the reference, whose callers jit
it there: the port's callers capture the decode step as a CUDA graph
(:class:`~repro_torch.runtime.compiled_step.CompiledStep`, in
``launch/serve.py``), and the train step runs eagerly.  A ``mesh``
(sharded training and serving) raises
:class:`~repro_torch.device.NotPortedError`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import NotPortedError
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply, tree_leaves,
                                     tree_map)
from repro_torch.optim.compression import ef_roundtrip

__all__ = ["make_prefill_step", "make_decode_step", "make_train_step",
           "abstract_train_state"]


def abstract_train_state(cfg: ModelConfig, compress_grads: bool = False
                         ) -> dict:
    """The train state's shapes and types as ``meta`` tensors (nothing
    allocated): the ``like`` tree of a restore."""
    from repro_torch.models import layers as L

    def leaf(d: L.ParamDef, dtype: torch.dtype | None = None):
        own = (torch.float32 if d.init in ("ssm_a", "dt_bias")
               else M.torch_dtype(cfg.dtype))
        return torch.empty(d.shape, dtype=dtype or own, device="meta")

    def tree(d, dtype=None):
        if isinstance(d, L.ParamDef):
            return leaf(d, dtype)
        return {k: tree(v, dtype) for k, v in d.items()}

    defs = M.param_defs(cfg)
    f32 = torch.float32
    state = {"params": tree(defs),
             "opt": {"master": tree(defs, f32), "m": tree(defs, f32),
                     "v": tree(defs, f32),
                     "step": torch.empty((), dtype=torch.int32,
                                         device="meta")}}
    if compress_grads:
        state["ef"] = tree(defs, f32)
    return state


def _no_mesh(mesh, what: str = "serving") -> None:
    if mesh is not None:
        raise NotPortedError(f"mesh= (sharded {what}, ROADMAP A9) is not "
                             f"ported yet")


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """step(params, {"tokens": (B, S)}, cache) -> (logits (B, V), cache)."""
    _no_mesh(mesh)

    def prefill_step(params, batch, cache):
        return M.prefill(params, cfg, batch["tokens"], cache,
                         enc_embeds=batch.get("enc_embeds"),
                         extra_embeds=batch.get("extra_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """step(params, {"token": (B,)}, cache) -> (logits (B, V), cache)."""
    _no_mesh(mesh)

    def decode_step(params, batch, cache):
        return M.decode_step(params, cfg, batch["token"], cache)

    return decode_step


def _grads(params: dict, cfg: ModelConfig, batch: dict
           ) -> tuple[torch.Tensor, dict, list]:
    """(total, metrics, gradients in :func:`tree_leaves` order) of one
    ``loss_fn`` call: one backward.  A parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives it.  The gradients are taken with
    respect to detached aliases of the parameters, so the caller's
    tensors keep ``requires_grad`` False and serve as before."""
    aliases = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(aliases)
    with torch.enable_grad():
        total, metrics = M.loss_fn(aliases, cfg, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    compress_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), the state
    ``{"params", "opt": {"master", "m", "v", "step"}, "ef"?}`` updated
    IN PLACE (:mod:`repro_torch.optim.adamw`).

    With ``cfg.microbatches`` > 1 the batch is split on its first axis
    the reference's way, the float32 gradients are accumulated ``/ mb``
    and the loss and metrics are the microbatches' means.  Then the
    error-feedback roundtrip (``compress_grads``), then AdamW.  Metrics:
    ``loss``, ``aux``, ``tokens``, ``lr``, ``grad_norm``, ``total_loss``,
    as 0-d tensors.
    """
    _no_mesh(mesh, "training")

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        mb = max(cfg.microbatches, 1)
        if mb == 1:
            loss, metrics, grads = _grads(params, cfg, batch)
        else:
            grads, losses, mets = None, [], []
            for j in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb,
                                     *v.shape[1:])[j]
                        for k, v in batch.items()}
                l, met, g = _grads(params, cfg, part)
                if grads is None:
                    grads = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                             for p in tree_leaves(params)]
                for a, gi in zip(grads, g):
                    a.add_(gi.to(torch.float32) / mb)
                del g
                losses.append(l)
                mets.append(met)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        if compress_grads:
            grads, _ = ef_roundtrip(grads, state["ef"])
        _, _, opt_metrics = adamw_apply(opt_cfg, params, grads, state["opt"])
        return state, {**metrics, **opt_metrics, "total_loss": loss}

    return train_step
