"""``fused_mlp``'s share of its roofline over the profiled training steps
(its forward calls, remat's recompute among them), in %."""
from __future__ import annotations


def read(rec):
    return rec.roofline("fused_mlp")
