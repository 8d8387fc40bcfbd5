"""The launch gate: a stream held until the host has enqueued a batch.

Timing events around launches the host is still enqueueing time the
host, not the card: on a card left idle the start event runs at once,
and the card then waits for each launch (on an NVIDIA H100 80GB HBM3, a
pair around a batched entry whose kernel the profiler times at 19-20 us
read 103-586 us, and 22.8-23.1 us behind a gate:
``tools/launch_span.py``).  :class:`LaunchGate` queues
``csrc/launch_gate.cu``'s one-thread kernel first; it spins until the
host releases its ticket, after the batch's last launch is queued, so
the events and kernels behind it run back to back.

The gate cannot hang a stream: after :data:`TIMEOUT_NS` it lets the
stream go and marks its ticket late, and :meth:`LaunchGate.late` then
says that the pair behind it waited on the host.  That is what happens
when the host waits for the card under the gate: a synchronizing call,
or a kernel's first launch (CUDA loads a kernel lazily, and loading
waits for the kernels running, the gate among them), as in a batch that
builds or first runs its kernels.  The gate computes nothing and has no
plain version; it runs on the card only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["LaunchGate", "TIMEOUT_NS"]

#: how long a gate holds its stream at most (a cold batch builds its
#: kernels under the gate and is let through after this)
TIMEOUT_NS = 20_000_000

_SOURCE = build.CudaSource("launch_gate")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong,
             ctypes.c_void_p]


class LaunchGate:
    """A gate on one card's current stream.

    ``words`` is pinned host memory the kernel reads and writes: ``[0]``
    is the last ticket released, ``[1]`` the last ticket that timed
    out.  Tickets count up from 1.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a launch gate holds a CUDA stream; got "
                             f"{self.device}")
        self.words = torch.zeros(2, dtype=torch.int32, pin_memory=True)
        self._ticket = 0

    def hold(self) -> int:
        """Queue the gate on the device's current stream; return the
        ticket that :meth:`release` lets it through with."""
        fn = _SOURCE.function("launch_gate_hold", _ARGTYPES)
        self._ticket += 1
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _SOURCE.check(fn(self.words.data_ptr(), self._ticket,
                             TIMEOUT_NS, stream))
        return self._ticket

    def release(self, ticket: int) -> None:
        """Let the gate of ``ticket`` (and every earlier one) through."""
        self.words[0] = ticket

    def late(self, ticket: int) -> bool:
        """Whether the gate of ``ticket`` or a later one timed out; read
        once the work behind the gate has finished."""
        return int(self.words[1]) >= ticket
