"""Mean host milliseconds of one prefill: the seconds of every admission
that prefilled in the traced window (the batcher's ``_admit``, timed by
the benchmark and synchronised at its end) over the prompts it
prefilled."""
from __future__ import annotations


def read(rec):
    n = rec.host.get("prefills", 0)
    return 1e3 * rec.host["prefill_s"] / n if n else None
