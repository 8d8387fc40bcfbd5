"""``fused_mlp``'s share of its roofline over the profiled stretch of
the traced window (prefills and decode steps), in %."""
from __future__ import annotations


def read(rec):
    return rec.roofline("fused_mlp")
