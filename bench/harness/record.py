"""What a traced run recorded, as the per-layer readers see it.

A reader (``bench/metrics/<metric>.py``) gets one :class:`Record` and
returns a number, or None where it finds nothing to read (a kernel that
is no longer on the path, a mix without prefills): the harness then
leaves that metric out of the result line.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from bench.counts import kernels as K
from bench.harness import profile as P

CSRC = Path(__file__).resolve().parents[2] / "src" / "repro_torch" / "csrc"


@dataclasses.dataclass
class Record:
    sizes: dict                       # the configuration's sizes
    traffic: dict                     # the mix's parameters
    trace: P.Trace | None = None      # the profiled stretch of the window
    #: host-side readings over the whole traced window, by name
    host: dict = dataclasses.field(default_factory=dict)
    #: per kernel, the least seconds its calls in the profiled stretch
    #: could take (bench.counts.kernels at the peaks of bench.counts.peaks)
    bounds: dict = dataclasses.field(default_factory=dict)

    def device_s(self, kernel: str) -> float:
        """Device seconds of ``kernel``'s launches (every pass of it) in
        the profiled stretch."""
        if self.trace is None:
            return 0.0
        pat = K.pattern(K.device_names(kernel, CSRC))
        if pat is None:
            return 0.0
        lo, hi = self.trace.window
        return sum(min(b, hi) - max(a, lo) for n, a, b in self.trace.device
                   if b > lo and a < hi and pat.search(n))

    def roofline(self, kernel: str) -> float | None:
        """``kernel``'s share of its roofline in %: the least time its
        calls could take over the time they took."""
        bound, took = self.bounds.get(kernel, 0.0), self.device_s(kernel)
        if bound <= 0 or took <= 0:
            return None
        return 100.0 * bound / took

    def idle_share(self) -> float | None:
        """The share of the profiled stretch with no device operation, %."""
        if self.trace is None or not self.trace.device:
            return None
        lo, hi = self.trace.window
        return 100.0 * (1.0 - P.busy_s(self.trace.device, (lo, hi))
                        / (hi - lo))
