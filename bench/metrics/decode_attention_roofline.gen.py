"""``decode_attention``'s share of its roofline over the profiled
stretch of the traced window, in %."""
from __future__ import annotations


def read(rec):
    return rec.roofline("decode_attention")
