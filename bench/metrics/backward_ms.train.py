"""Device milliseconds a step of the operations launched inside the
program's ``train.backward`` spans (``torch.autograd.grad``: the plain
backwards and remat's recompute), over the profiled training steps (one
``train.optimizer`` span a step)."""
from __future__ import annotations

from bench.harness import spans


def read(rec):
    return spans.device_ms_per(rec, "train.backward", "train.optimizer")
