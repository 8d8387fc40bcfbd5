"""AdamW, written out in float32: the optimizer the reference trains
with.  Decoupled weight decay on every leaf, bias-corrected moments,
the gradients clipped to a global norm first, the learning rate warmed
up linearly from 0 and then decayed along a cosine to ``lr_min``; the
step count starts at 1.  The settings come from the traffic mix's file
(``adamw``), the same ones the program is given.
"""
from __future__ import annotations

import math

import torch


def lr_at(cfg: dict, step: int) -> float:
    """The learning rate of step ``step`` (1, 2, ...)."""
    if step < cfg["warmup_steps"]:
        return cfg["lr_peak"] * step / max(cfg["warmup_steps"], 1)
    t = min(max((step - cfg["warmup_steps"])
                / max(cfg["decay_steps"] - cfg["warmup_steps"], 1), 0.0), 1.0)
    return cfg["lr_min"] + 0.5 * (cfg["lr_peak"] - cfg["lr_min"]) * (
        1.0 + math.cos(math.pi * t))


class AdamW:
    """State over a list of float32 leaves (the parameters themselves)."""

    def __init__(self, cfg: dict, params: list[torch.Tensor]):
        self.cfg, self.params = cfg, params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step = 0

    @torch.no_grad()
    def apply(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """One step in place; returns the clipped gradients, as the
        moments take them."""
        c = self.cfg
        self.step += 1
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = min(1.0, c["clip_norm"] / (float(norm) + 1e-9))
        lr = lr_at(c, self.step)
        b1c = 1.0 - c["b1"] ** self.step
        b2c = 1.0 - c["b2"] ** self.step
        clipped = []
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            g = g * scale
            clipped.append(g)
            m.mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
            v.mul_(c["b2"]).addcmul_(g, g, value=1 - c["b2"])
            upd = (m / b1c) / ((v / b2c).sqrt() + c["eps"])
            p.sub_(lr * (upd + c["weight_decay"] * p))
        return clipped
