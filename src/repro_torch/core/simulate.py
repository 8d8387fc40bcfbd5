"""Cycle-level FIFO-pipeline latency model (reproduces paper Fig. 1).

The paper's central performance claim: a kernel compiled *without* the
dataflow transformation executes its tasks sequentially under one FSM
(latency ~= sum of task latencies), while the dataflow-transformed
kernel runs tasks as a FIFO-connected pipeline (latency ~= latency of
the slowest task + pipeline fill).

We model a task as a server with issue interval ``ii`` (cycles/item)
and pipeline-fill latency ``fill``; channels are FIFOs of finite
``depth``.  Two models:

- :func:`analytic_latency` — closed forms for both executions.
- :func:`simulate_pipeline` — discrete recurrence with backpressure,
  for finite FIFO depths and per-item jitter (straggler studies).

The same model yields the GPU reading: thread blocks of the fused
group kernel are the "items"; the halo load, the compute stages and the
store are the tasks.

Port of :mod:`repro.core.simulate` (numpy only, copied as is).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TaskTiming", "analytic_latency", "simulate_pipeline"]


@dataclasses.dataclass(frozen=True)
class TaskTiming:
    name: str
    ii: float = 1.0       # cycles per item (issue interval)
    fill: float = 8.0     # pipeline-fill latency in cycles


def analytic_latency(tasks: list[TaskTiming], n_items: int
                     ) -> dict[str, float]:
    """Closed-form latencies (cycles) for both execution styles.

    sequential (no dataflow): tasks run one after another over the full
    stream::

        T_seq = sum_i (fill_i + n * ii_i)

    dataflow (pipelined): every task runs concurrently; the stream
    drains at the rate of the slowest task::

        T_flow = sum_i fill_i + n * max_i ii_i

    ``n_items=0`` is legal (an idle pipeline): both latencies collapse
    to the fill terms, and a fully zero-cost pipeline reports speedup
    1.0 instead of dividing by zero.
    """
    if n_items < 0:
        raise ValueError(f"n_items must be >= 0, got {n_items}")
    t_seq = sum(t.fill + n_items * t.ii for t in tasks)
    t_flow = sum(t.fill for t in tasks) + n_items * max(t.ii for t in tasks)
    return {"sequential": t_seq, "dataflow": t_flow,
            "speedup": t_seq / t_flow if t_flow > 0 else 1.0}


def simulate_pipeline(tasks: list[TaskTiming], n_items: int,
                      depth: int = 2, jitter: float = 0.0,
                      seed: int = 0) -> dict[str, float]:
    """Discrete recurrence with finite-FIFO backpressure.

    ``c[s, k]`` = cycle when task ``s`` finishes item ``k``::

        c[s, k] = max(c[s-1, k],            # data available
                      c[s, k-1],            # server busy
                      c[s+1, k-depth])      # room in output FIFO
                  + ii_s (+ jitter)

    plus each task's one-time ``fill``.  With ``depth>=1`` and constant
    ii this converges to the analytic dataflow latency; with jittered
    service times it quantifies how FIFO depth absorbs stalls (the
    paper's "when a task stalls ... other tasks continue running as
    long as there is enough data in their input buffers").
    """
    if n_items < 1:
        raise ValueError(f"simulate_pipeline needs n_items >= 1, "
                         f"got {n_items}")
    rng = np.random.default_rng(seed)
    S = len(tasks)
    c = np.zeros((S, n_items))
    ii = np.array([t.ii for t in tasks])
    fill = np.array([t.fill for t in tasks])
    jit = (rng.exponential(jitter, size=(S, n_items))
           if jitter > 0 else np.zeros((S, n_items)))
    for k in range(n_items):
        for s in range(S):
            ready = c[s - 1, k] if s > 0 else 0.0
            busy = c[s, k - 1] if k > 0 else fill[:s + 1].sum()
            # backpressure: the *downstream* task must have accepted
            # item k-depth before we may emit item k into the FIFO
            room = c[s + 1, k - depth] if (s + 1 < S and k >= depth) else 0.0
            c[s, k] = max(ready, busy, room) + ii[s] + jit[s, k]
    total = float(c[-1, -1])
    seq = float(sum(t.fill + (n_items * t.ii) for t in tasks)
                + jit.sum())
    # steady rate over the back half: items n//2 .. n-1 span
    # n-1-n//2 completion intervals (NOT n-n//2 — fenceposts).  For
    # constant ii and depth >= 1 this equals max_i ii_i exactly.
    intervals = n_items - 1 - n_items // 2
    if intervals > 0:
        steady = float((c[-1, -1] - c[-1, n_items // 2]) / intervals)
    else:
        steady = total / n_items
    return {"dataflow_sim": total, "sequential": seq,
            "speedup": seq / total, "steady_rate": steady}
