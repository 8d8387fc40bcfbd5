"""``moe_experts``' share of its roofline over the profiled stretch of
the traced window (prefills and decode steps), in %: the weights of the
experts the tokens reach, read once, over the device time of the
kernel's three passes."""
from __future__ import annotations


def read(rec):
    return rec.roofline("moe_experts")
