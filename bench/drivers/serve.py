"""The serving driver: a closed loop of clients against the port's
continuous batcher (``repro_torch.runtime.batcher.ContinuousBatcher``).

A mix of ``kind`` "serve" gives the slots, the cache's positions and
type, the number of clients, and the laws of the prompts' and answers'
lengths (``bench/traffic/<mix>.json``).  Each client sends its next
request when its last one finishes.  Set-up fills every slot with a
first wave drawn from the same laws (a log-uniform budget spread over
more than a decade retires the slots at staggered times, much as the
budgets left to requests in flight would), and runs the steps that
warm the path up (the decode step's eager first call and its capture as
one CUDA graph).  Then the window: ``step()`` after ``step()`` until the
run's seconds have passed.

End to end:

- ``gen_tokens_per_s``: every token the requests received in the window
  (first tokens and decoded tokens) over the window's seconds;
- ``ttft_p95_ms``: the 95th percentile, over every request whose first
  token arrived in the window, of the time from its submission by the
  client to the return of the ``step()`` that produced that token.

The lengths follow one low-discrepancy sequence, the same for every seed
(runs whose seeds also moved the sizes spread more); the seed draws the
token ids, uniform over the vocabulary, and the sample the check reads.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time

import numpy as np

from bench import families
from bench.counts import flops as FL
from bench.counts import kernels as K
from bench.harness.cell import Cell, port_config
from bench.harness.profile import Trace
from bench.harness.record import Record
from bench.reference import check
from bench.reference.weights import make_weights

#: steps of the low-discrepancy sequences (the golden ratio's and
#: sqrt(2)'s fractional parts)
_PHI, _SQRT2 = (math.sqrt(5) - 1) / 2, math.sqrt(2) - 1


def _length(law: dict, u: float) -> int:
    lo, hi = law["min"], law["max"]
    if law["law"] == "uniform":
        return lo + min(int(u * (hi - lo + 1)), hi - lo)
    if law["law"] == "log_uniform":
        x = math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return min(max(int(x + 1e-9), lo), hi)
    raise ValueError(f"unknown length law {law['law']!r}")


class Requests:
    """The mix's requests, in the order the clients send them."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng([seed, 1])
        self.k = 0

    def next(self):
        from repro_torch.runtime.batcher import Request
        k = self.k
        self.k += 1
        S = _length(self.mix["prompt_tokens"], (0.5 + k * _PHI) % 1.0)
        n = _length(self.mix["output_tokens"], (0.5 + k * _SQRT2) % 1.0)
        prompt = self.rng.integers(0, self.vocab, size=S).astype(np.int32)
        return Request(rid=k, prompt=prompt, max_new_tokens=n)


def traced_batcher(base, torch, sync):
    """``base`` (the batcher class) with the benchmark's records around
    its admissions and decode steps: host seconds of each admission that
    prefilled (synchronised), the admitted prompts' lengths, CUDA events
    around each decode call, the slots' lengths and the live slots, and
    each one's kernel calls from the port's launch counters."""
    from repro_torch.runtime.compiled_step import launch_counters
    counters = {fn.__name__: fn for fn in launch_counters()}

    def snap():
        return {n: fn.launches for n, fn in counters.items()}

    def delta(before):
        return {n: fn.launches - before[n] for n, fn in counters.items()}

    class Traced(base):
        profiling = False

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admits, self.decodes = [], []

        def _admit(self):
            queued = list(self.queue)
            n0, c0 = self.prefills, snap()
            t0 = time.perf_counter()
            super()._admit()
            sync()
            k = self.prefills - n0
            if k:
                self.admits.append({
                    "s": time.perf_counter() - t0,
                    "lengths": [len(r.prompt) for r in queued[:k]],
                    "calls": delta(c0), "profiled": self.profiling})

        def _decode_step(self, tokens, lengths):
            c0 = snap()
            events = None
            if self.device.type == "cuda":
                events = tuple(torch.cuda.Event(enable_timing=True)
                               for _ in range(2))
                events[0].record()
            out = super()._decode_step(tokens, lengths)
            if events is not None:
                events[1].record()
            self.decodes.append({"events": events,
                                 "lengths": [int(n) for n in lengths],
                                 "active": self.active, "calls": delta(c0),
                                 "profiled": self.profiling})
            return out
    return Traced


@dataclasses.dataclass
class Loop:
    """The clients: one outstanding request each, the next sent when the
    last finishes."""
    batcher: object
    requests: Requests
    submitted: dict = dataclasses.field(default_factory=dict)   # rid -> t
    first: dict = dataclasses.field(default_factory=dict)       # rid -> t
    done: dict = dataclasses.field(default_factory=dict)        # rid -> t
    waiting: list = dataclasses.field(default_factory=list)
    n_finished: int = 0

    def send(self, t: float) -> None:
        r = self.requests.next()
        self.submitted[r.rid] = t
        self.waiting.append(r)
        self.batcher.submit(r)

    def finished(self, t: float) -> None:
        """A request finished at ``t``: its client sends the next."""
        self.send(t)

    def step(self) -> tuple[float, int]:
        """One ``step()``; returns (its return time, tokens it gave)."""
        produced = self.batcher.step()
        t = time.perf_counter()
        got = [r for r in self.waiting if r.tokens]
        if got:
            self.waiting = [r for r in self.waiting if not r.tokens]
            for r in got:
                self.first[r.rid] = t
        fin = self.batcher.finished
        for r in fin[self.n_finished:]:
            self.done[r.rid] = t
            self.finished(t)
        self.n_finished = len(fin)
        return t, produced + len(got)


def _p95(values: list[float]) -> float:
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _bounds(cell: Cell, admits: list, decodes: list) -> dict:
    """Per kernel, the least seconds of its calls in the profiled
    stretch: each admission's calls spread evenly over its prompts, each
    decode step's over the calls the family lists at that step's
    lengths."""
    fam, sz, mix = families.counts(cell.family), cell.sizes, cell.traffic
    out: dict[str, float] = {}

    def add(bounds):
        for kernel, secs in bounds.items():
            out[kernel] = out.get(kernel, 0.0) + secs

    for a in admits:
        if a["profiled"]:
            n = len(a["lengths"])
            per_prompt = {k: c / n for k, c in a["calls"].items()}
            for S in a["lengths"]:
                add(K.bounds(fam.prefill_calls(sz, mix, S), per_prompt))
    for s in decodes:
        if s["profiled"]:
            add(K.bounds(fam.decode_calls(sz, mix, s["lengths"]),
                         s["calls"]))
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        sync, window_opens, control: str | None = None) -> dict:
    """One run; with ``control`` (a precision of the reference) the
    result also holds the control's and an altered token's readings on
    the same sample (``bench/calibrate.py``)."""
    import torch
    from repro_torch.runtime.batcher import ContinuousBatcher

    sz, mix = cell.sizes, cell.traffic
    cfg = port_config(cell.config)
    t_made = time.perf_counter()
    params = make_weights(sz, seed, device)
    base = (traced_batcher(ContinuousBatcher, torch, sync) if trace
            else ContinuousBatcher)
    batcher = base(cfg, params, mix["slots"], mix["cache_positions"],
                   dtype=getattr(torch, mix["cache_dtype"]), device=device)
    loop = Loop(batcher, Requests(mix, seed, sz["vocab_size"]))
    t = time.perf_counter()
    made = t - t_made
    for _ in range(mix["clients"]):
        loop.send(t)
    for _ in range(mix["warm_steps"]):     # every prefill, the capture
        loop.step()
    sync()
    gc.collect()
    gc.freeze()                # set-up's objects: out of the collector's way
    if trace:                  # the records are of the window alone
        batcher.admits.clear()
        batcher.decodes.clear()

    # -- the window -------------------------------------------------------
    if trace:
        Trace.warm(torch, sync)
    window_opens()
    t0 = time.perf_counter()
    setup_parts = {"weights_and_cache": made, "first_wave": t0 - t}
    tokens, tr = 0, None
    tcfg = mix["trace"]
    while True:
        if trace and tr is None and time.perf_counter() - t0 >= \
                tcfg["start_share"] * seconds:
            tr = Trace(torch, sync)
            tr.__enter__()
            batcher.profiling, tr_steps, tr_t0 = True, 0, time.perf_counter()
        t, n = loop.step()
        tokens += n
        if tr is not None and batcher.profiling:
            tr_steps += 1
            if (tr_steps >= tcfg["max_steps"]
                    or time.perf_counter() - tr_t0 >= tcfg["max_s"]):
                tr.__exit__(None, None, None)
                batcher.profiling = False
        if t - t0 >= seconds:
            break
    if tr is not None and batcher.profiling:
        tr.__exit__(None, None, None)
        batcher.profiling = False
    sync()
    window_s = t - t0
    ttft = [loop.first[rid] - loop.submitted[rid]
            for rid, tf in loop.first.items() if tf >= t0]
    result = {"metrics": {"gen_tokens_per_s": tokens / window_s,
                          "ttft_p95_ms": _p95(ttft) * 1e3},
              "attempted": len(ttft), "failed": 0,
              "setup_parts": setup_parts,
              "load": {"queued_at_end": len(batcher.queue),
                       "finished": sum(t >= t0 for t in loop.done.values()),
                       "sent": sum(t >= t0 for t in loop.submitted.values())},
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_available() else 0)}
    if trace:
        result["record"] = _record(cell, batcher, tr, window_s)
        result["trace_cost"] = _trace_cost(batcher.admits, batcher.decodes)

    # -- the check --------------------------------------------------------
    t_check = time.perf_counter()
    finished = [r for r in batcher.finished if loop.done[r.rid] >= t0]
    served = [(np.asarray(r.prompt), list(r.tokens))
              for r in _sample(finished, seed, mix["check_sample"])]
    result["load"]["checked_tokens"] = sum(len(t) for _, t in served)
    del batcher, loop, params, base
    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref_params = make_weights(sz, seed, device)
    # no finished request to judge is a failed check, not a pass
    result["checks"] = {"served_gap": (
        check.served_gap(ref_params, sz, served, device) if served
        else float("inf"))}
    result["seconds"] = {"window": window_s,
                         "check": time.perf_counter() - t_check}
    if control and served:
        result["control"] = {
            "served_gap": check.control_gap(ref_params, sz, served, device,
                                            control),
            "altered_token": check.altered_gap(ref_params, sz, served,
                                               device, seed)}
    return result


def _sample(finished: list, seed: int, k: int) -> list:
    """The longest finished request and ``k - 1`` others drawn from the
    seed."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-len(r.tokens), r.rid))
    rest = order[1:]
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [order[0]] + [rest[i] for i in sorted(pick)]


def _trace_cost(admits: list, decodes: list) -> dict:
    """Mean ms of a decode step (CUDA events) and of a prefill (host
    clock, synchronised) inside the profiled stretch and outside it:
    what the profiler adds to each, and so to the idle share read
    there."""
    out = {}
    for where, flag in (("profiled", True), ("unprofiled", False)):
        ms = [s["events"][0].elapsed_time(s["events"][1]) for s in decodes
              if s["events"] is not None and s["profiled"] == flag]
        if ms:
            out[f"decode_ms_{where}"] = statistics.fmean(ms)
        n = sum(len(a["lengths"]) for a in admits if a["profiled"] == flag)
        if n:
            out[f"prefill_ms_{where}"] = 1e3 * sum(
                a["s"] for a in admits if a["profiled"] == flag) / n
    return out


def _record(cell: Cell, batcher, tr, window_s: float) -> Record:
    sz = cell.sizes
    admits, decodes = batcher.admits, batcher.decodes
    decode_ms = [s["events"][0].elapsed_time(s["events"][1])
                 for s in decodes if s["events"] is not None]
    prompt_flops = sum(FL.prompt_flops(sz, S) for a in admits
                       for S in a["lengths"])
    # the live slots' tokens: a slot in use holds at least its prompt
    decode_flops = sum(FL.decode_flops(sz, [n for n in s["lengths"] if n])
                       for s in decodes)
    host = {"window_s": window_s,
            "prefill_s": sum(a["s"] for a in admits),
            "prefills": sum(len(a["lengths"]) for a in admits),
            "flops": prompt_flops + decode_flops,
            "decode_ms": decode_ms,
            "active": [s["active"] for s in decodes],
            "slots": cell.traffic["slots"]}
    return Record(sizes=sz, traffic=cell.traffic, trace=tr, host=host,
                  bounds=_bounds(cell, admits, decodes))
