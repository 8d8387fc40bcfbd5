"""Device milliseconds a step of the kernels launched under the
``FlashAttentionFn`` and ``FusedMlpFn`` backward nodes
(the plain versions recomputed and differentiated), over the profiled
steps."""
from __future__ import annotations


def read(rec):
    if rec.trace is None or not rec.trace.backward_s:
        return None
    total = sum(rec.trace.backward_s.values())
    return 1e3 * total / rec.host["profiled_steps"] if total else None
