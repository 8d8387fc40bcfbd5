"""The share of the profiled training steps in which no operation ran on
the device, in %."""
from __future__ import annotations


def read(rec):
    return rec.idle_share()
