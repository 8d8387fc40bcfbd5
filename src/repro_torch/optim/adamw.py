"""AdamW with float32 master weights, global-norm clipping and the LR
schedule (the port of ``repro.optim.adamw``).

The state is the reference's tree: ``{"master", "m", "v"}`` (float32,
the parameters' structure) and ``"step"`` (an int32 scalar).  The
arithmetic is the reference's, in float32, but the update is IN PLACE,
where the reference returns new trees: a functional copy of granite's
30 GB of float32 state would not fit beside its weights on one card.
The clip's scale is folded into each leaf's update (one leaf's float32
gradient exists at a time, never a clipped copy of the whole tree), and
the parameters are recast from the master copy in place.

Under a mesh the leaves are ``ShardedTensor``s
(:mod:`repro_torch.parallel.sharding`): each mesh position updates its
own pieces of the parameters, master, m and v in place from its slice
of the reduced gradient, and the global norm adds each distinct piece
once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_apply", "lr_schedule",
           "global_norm", "clip_by_global_norm", "tree_leaves", "tree_map",
           "pieces", "each_piece"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a dict tree in sorted-key order, as ``jax.tree``
    flattens a dict."""
    if not isinstance(tree, dict):
        return [tree]
    return [t for k in sorted(tree) for t in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dict trees of one structure, in
    :func:`tree_leaves` order."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to lr_min, in float32 as the
    reference computes it (``step`` an int scalar or tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) \
        * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def pieces(t: Any) -> list[torch.Tensor]:
    """The tensors that hold leaf ``t``: itself, or every mesh position's
    piece of a ``ShardedTensor``."""
    return [t] if isinstance(t, torch.Tensor) else t.pieces()


def each_piece(t: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn(t)``, or ``fn`` on every piece of a ``ShardedTensor``."""
    return fn(t) if isinstance(t, torch.Tensor) else t.map(fn)


def _sq_norm(g: Any) -> torch.Tensor:
    """sum(g^2) in float32, without a float32 copy of ``g``; over each
    distinct piece of a ``ShardedTensor``, on its first piece's device."""
    if isinstance(g, torch.Tensor):
        return torch.linalg.vector_norm(g, dtype=torch.float32).square()
    parts = [_sq_norm(t) for t in g.leader_pieces()]
    return torch.stack([q.to(parts[0].device) for q in parts]).sum()


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm over a tree's leaves, or over a list of
    leaves."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    sq = [_sq_norm(g) for g in leaves]
    return torch.stack([q.to(sq[0].device) for q in sq]).sum().sqrt()


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """The reference's clip, as a new float32 tree: kept for parity with
    the reference's API.  The training path does not use it:
    ``adamw_apply`` folds the scale into each leaf's update instead, so
    no clipped float32 copy of the gradients exists."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def adamw_init(params: Any) -> dict:
    """float32 master copy (always a copy), zero m and v, step 0.  Over
    ``ShardedTensor`` parameters each piece gets its own, and the step
    is replicated on every mesh position."""
    f32 = torch.float32
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return each_piece(p, lambda t: torch.zeros(t.shape, dtype=f32,
                                                   device=t.device))
    step = torch.zeros((), dtype=torch.int32,
                       device=pieces(leaf)[0].device)
    if not isinstance(leaf, torch.Tensor):
        from repro_torch.parallel.sharding import NamedSharding, P
        step = NamedSharding(leaf.mesh, P()).shard(step)
    return {"master": tree_map(lambda p: each_piece(
                p, lambda t: t.detach().to(f32, copy=True)), params),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def _update(cfg: AdamWConfig, p, mst, m, v, g, scale, lr, b1c, b2c):
    """One leaf's (or one piece's) update, in place."""
    g = g.to(torch.float32) * scale
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
    upd = torch.div(m, b1c).div_(denom).add_(mst, alpha=cfg.weight_decay)
    mst.sub_(upd.mul_(lr))
    p.copy_(mst)


@torch.no_grad()
def adamw_apply(cfg: AdamWConfig, params: Any, grads: Any, state: dict
                ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params`` and ``state``.  ``grads``
    is a tree like ``params`` or its leaves in :func:`tree_leaves`
    order (a list, whose entries are set to None as they are used, so
    each gradient is freed after its update).  Over ``ShardedTensor``
    leaves (the gradients split like the parameters) each mesh position
    updates its pieces with the scalars moved to its device.
    Returns (params, state, {"lr", "grad_norm"}), the same objects."""
    f32 = torch.float32
    for t in pieces(state["step"]):
        t += 1
    first = pieces(state["step"])[0]
    step = first.to(f32)
    lr = lr_schedule(cfg, first)
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    norm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / (norm + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    scalars = {}

    def on(dev):               # (scale, lr, b1c, b2c) on ``dev``
        if dev not in scalars:
            scalars[dev] = tuple(x.to(dev) for x in (scale, lr, b1c, b2c))
        return scalars[dev]

    leaves = zip(tree_leaves(params), tree_leaves(state["master"]),
                 tree_leaves(state["m"]), tree_leaves(state["v"]))
    for i, leaf in enumerate(leaves):
        gs = pieces(flat_g[i])
        flat_g[i] = None            # each gradient freed after its update
        for p, mst, m, v in zip(*map(pieces, leaf)):
            _update(cfg, p, mst, m, v, gs.pop(0), *on(p.device))
    return params, state, {"lr": lr, "grad_norm": norm}
