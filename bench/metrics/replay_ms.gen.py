"""Mean device milliseconds of one replay of the captured decode step:
the operations launched inside the program's ``compiled.replay`` spans
over the profiled stretch, per replay."""
from __future__ import annotations

from bench.harness import spans


def read(rec):
    return spans.device_ms_per(rec, "compiled.replay", "compiled.replay")
