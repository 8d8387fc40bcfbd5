"""Model FLOPs of every token the traced window processed (its prompts'
tokens and each decode step's live slots; ``bench.counts.flops``) over
the window's seconds, as a share of the bf16 peak, in %."""
from __future__ import annotations

from bench.counts import peaks


def read(rec):
    if not rec.host.get("flops"):
        return None
    return 100.0 * rec.host["flops"] / rec.host["window_s"] / peaks.BF16_FLOPS
