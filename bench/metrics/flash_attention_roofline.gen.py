"""``flash_attention``'s share of its roofline over the prefills in the
profiled stretch of the traced window, in %."""
from __future__ import annotations


def read(rec):
    return rec.roofline("flash_attention")
