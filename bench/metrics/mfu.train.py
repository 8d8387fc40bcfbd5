"""Model FLOPs of a training step (``bench.counts.flops``: three times
the forward's, remat's recompute not counted) over the mean host
seconds of the traced window's unprofiled steps, each synchronised, as
a share of the bf16 peak, in %."""
from __future__ import annotations

from bench.counts import peaks


def read(rec):
    steps = rec.host.get("step_s") or []
    if not steps:
        return None
    return (100.0 * rec.host["step_flops"] / (sum(steps) / len(steps))
            / peaks.BF16_FLOPS)
