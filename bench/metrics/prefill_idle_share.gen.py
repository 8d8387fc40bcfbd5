"""The share of the profiled stretch of the traced window in which no
operation ran on the device while the host was inside the program's
``batcher.prefill`` span (a B = 1 prefill, up to its first token's read),
in %."""
from __future__ import annotations

from bench.harness import spans


def read(rec):
    return spans.idle_share_under(rec, "batcher.prefill")
