"""The share of the profiled stretch of the traced window in which no
operation ran on the device, in %."""
from __future__ import annotations


def read(rec):
    return rec.idle_share()
