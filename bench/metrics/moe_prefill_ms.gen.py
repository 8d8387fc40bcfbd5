"""Mean device milliseconds of the MoE layers in one B = 1 prefill: the
operations launched inside the program's ``moe.layer`` spans (routing,
the sort by expert, the routed and the shared experts) over the
profiled stretch, per ``batcher.prefill`` span begun in it.  A captured
decode step opens no span on replay, so only prefills count."""
from __future__ import annotations

from bench.harness import layer_spans


def read(rec):
    return layer_spans.device_ms_per(rec, "moe.layer", "batcher.prefill")
