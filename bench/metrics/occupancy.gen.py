"""Mean share of the batcher's slots that held a request, over the
traced window's decode steps, in %."""
from __future__ import annotations


def read(rec):
    active = rec.host.get("active") or []
    if not active:
        return None
    return 100.0 * sum(active) / (len(active) * rec.host["slots"])
