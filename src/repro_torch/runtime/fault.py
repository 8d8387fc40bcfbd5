"""Fault-tolerance machinery: stragglers, heartbeats, preemption (a copy
of ``repro.runtime.fault``: numpy and signals, no framework).

At 1000+ nodes, something is always broken.  The framework's posture:

- **Checkpoint/restart** is the base mechanism (async, atomic, elastic
  — see repro_torch.checkpoint).  The Trainer auto-saves every N steps and
  on SIGTERM (preemption notice), and resumes from the newest intact
  checkpoint (the port: one process, which drives a mesh's devices
  itself; a restore reshards onto any mesh).
- **Straggler mitigation**: per-host step-time EWMA; hosts slower than
  ``factor`` x the fleet median for ``patience`` consecutive windows
  are flagged for replacement.  (On real fleets the replacement is an
  external scheduler action; here the monitor's decisions are unit-
  tested against synthetic traces.)
- **Heartbeats**: liveness registry with a deadline; dead hosts
  trigger an elastic-restart decision (shrink to the survivors'
  mesh, restore, continue).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np

__all__ = ["StragglerMonitor", "HeartbeatRegistry", "PreemptionGuard"]


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2          # EWMA smoothing
    factor: float = 1.5         # slower than factor x median => suspect
    patience: int = 3           # consecutive suspect windows => straggler

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.strikes = np.zeros(self.n_hosts, dtype=int)
        self._seen = np.zeros(self.n_hosts, dtype=bool)

    def observe(self, host_step_times: np.ndarray) -> list[int]:
        """Feed one step's per-host wall times; returns flagged hosts.

        Strikes count *consecutive raw* slow windows (a single spike
        resets next step); the EWMA is kept for reporting/telemetry.
        """
        t = np.asarray(host_step_times, dtype=float)
        new = ~self._seen
        self.ewma[new] = t[new]
        self._seen |= True
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        med = np.median(t)
        suspect = t > self.factor * med
        self.strikes = np.where(suspect, self.strikes + 1, 0)
        return list(np.nonzero(self.strikes >= self.patience)[0])


@dataclasses.dataclass
class HeartbeatRegistry:
    n_hosts: int
    deadline_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last = np.full(self.n_hosts, now)

    def beat(self, host: int) -> None:
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return list(np.nonzero(now - self.last > self.deadline_s)[0])

    def survivors(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [h for h in range(self.n_hosts) if h not in dead]


class PreemptionGuard:
    """SIGTERM -> set a flag the training loop polls; the loop then
    checkpoints synchronously and exits cleanly (cloud preemption
    contract).  Context-manager restores the previous handler."""

    def __init__(self):
        self.preempted = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self.preempted = True

        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)
        return False
