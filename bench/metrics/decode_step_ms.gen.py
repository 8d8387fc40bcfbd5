"""Mean milliseconds of one decode step: CUDA events around each call of
the batcher's ``_decode_step`` (the staging copies, the captured
step's replay, the logits' copy) over the traced window's steps."""
from __future__ import annotations


def read(rec):
    ms = rec.host.get("decode_ms") or []
    return sum(ms) / len(ms) if ms else None
