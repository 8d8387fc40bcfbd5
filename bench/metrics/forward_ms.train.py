"""Device milliseconds a step of the operations launched inside the
program's ``train.forward`` spans (``M.loss_sums`` over the data shards,
and the loss), over the profiled training steps (one
``train.optimizer`` span a step)."""
from __future__ import annotations

from bench.harness import spans


def read(rec):
    return spans.device_ms_per(rec, "train.forward", "train.optimizer")
