"""Device milliseconds a step of the operations launched inside the
program's ``train.optimizer`` spans (the error-feedback roundtrip where
it is on, then AdamW), over the profiled training steps."""
from __future__ import annotations

from bench.harness import spans


def read(rec):
    return spans.device_ms_per(rec, "train.optimizer", "train.optimizer")
