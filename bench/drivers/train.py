"""The training driver: the step that ``repro_torch.runtime.steps.
make_train_step`` returns, with AdamW and an unsharded state, fed
batches of token ids that the benchmark draws from the seed.

A mix of ``kind`` "train" gives the batch, the sequence length and
AdamW's settings (``bench/traffic/<mix>.json``).  Set-up builds the one
train state from the run's weights and drives it through its first
``check_steps`` steps with the window's own call and feed; the program's
readings for the check are taken there (each step's loss, the total its
gradient is taken of: the cross entropy and any term the layers add, as
the reference's; the first gradient's norm per leaf from the state after
step 1; the parameters' change per leaf after the last of them).  The window then goes on with
the same object and new batches until the run's seconds have passed.

End to end: ``train_tokens_per_s``, the tokens of every step the window
ran over the window's seconds (from the first step's call to the device
finishing the last one).
"""
from __future__ import annotations

import gc
import time

from bench import families
from bench.counts import flops as FL
from bench.counts import kernels as K
from bench.harness.cell import Cell, port_config
from bench.harness.profile import Trace
from bench.harness.record import Record
from bench.reference import check
from bench.reference.weights import flat, iter_weights, make_weights

#: the autograd nodes whose backward runs the kernels' plain versions
BACKWARD_NODES = ("FlashAttentionFnBackward", "FusedMlpFnBackward")


class Feed:
    """Batches of uniform token ids, (B, S) with next-token labels, drawn
    in order on the device from the seed."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        import torch
        self.torch, self.mix, self.vocab = torch, mix, vocab
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def next(self) -> dict:
        B, S = self.mix["batch"], self.mix["seq_len"]
        ids = self.torch.randint(0, self.vocab, (B, S + 1),
                                 generator=self.gen, device=self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _leaf_norms(tree: dict, scale: float = 1.0) -> dict:
    return {"/".join(p): float(t.float().norm()) * scale
            for p, t in flat(tree)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        sync, window_opens, control: str | None = None) -> dict:
    """One run; with ``control`` (a precision of the reference) the
    result also holds the numbers of the reference in that precision put
    in the program's place (``bench/calibrate.py``)."""
    import torch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step

    sz, mix = cell.sizes, cell.traffic
    cfg = port_config(cell.config)
    adamw = mix["adamw"]
    t_made = time.perf_counter()
    params = make_weights(sz, seed, device)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(cfg, AdamWConfig(**adamw))
    feed = Feed(mix, sz["vocab_size"], seed, device)

    # -- set-up: the first steps, read for the check ----------------------
    t_first = time.perf_counter()
    prog = {"loss": []}
    for i in range(mix["check_steps"]):
        state, met = step(state, feed.next())
        prog["loss"].append(float(met["total_loss"]))
        if i == 0:     # m = (1 - b1) g after one step: g as AdamW takes it
            prog["grad_norms"] = _leaf_norms(state["opt"]["m"],
                                             1.0 / (1.0 - adamw["b1"]))
            m = flat(state["opt"]["m"])
            prog["grad_sample"] = dict(zip(
                ("/".join(p) for p, _ in m), check.sample_leaves(
                    [t for _, t in m], seed, 1.0 / (1.0 - adamw["b1"]))))
            del m
    with torch.no_grad():
        master = dict(flat(state["opt"]["master"]))
        prog["change_norms"] = {
            "/".join(p): float((master[p] - p0.float()).norm())
            for p, p0 in iter_weights(sz, seed, device)}
        del master
    sync()
    gc.collect()

    # -- the window -------------------------------------------------------
    tokens_per_step = mix["batch"] * mix["seq_len"]
    counters = _counters()
    tr, host_steps, steps, losses = None, [], 0, []
    if trace:
        Trace.warm(torch, sync)
    window_opens()
    t0 = time.perf_counter()
    setup_parts = {"weights_and_state": t_first - t_made,
                   "first_steps": t0 - t_first}
    while True:
        if trace and steps == mix["trace"]["after_steps"]:
            c0 = {n: fn.launches for n, fn in counters.items()}
            tr = Trace(torch, sync, BACKWARD_NODES)
            with tr:
                for _ in range(mix["trace"]["steps"]):
                    state, met = step(state, feed.next())
                    losses.append(met["loss"])
                    steps += 1
            calls = {n: fn.launches - c0[n] for n, fn in counters.items()}
            continue
        ts = time.perf_counter()
        state, met = step(state, feed.next())
        losses.append(met["loss"])
        steps += 1
        if trace:              # each step timed alone in the traced run
            sync()
            host_steps.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= seconds and (
                not trace or tr is not None):
            break
    sync()
    window_s = time.perf_counter() - t0
    failed = sum(not bool(torch.isfinite(x)) for x in losses)
    result = {"metrics": {"train_tokens_per_s":
                          steps * tokens_per_step / window_s},
              "attempted": steps, "failed": failed,
              "setup_parts": setup_parts,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_available() else 0)}
    if trace:
        result["record"] = _record(cell, tr, calls, host_steps)

    # -- the check --------------------------------------------------------
    t_check = time.perf_counter()
    del state, step, params, met, losses
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    feed = Feed(mix, sz["vocab_size"], seed, device)
    batches = [feed.next() for _ in range(mix["check_steps"])]
    ref = check.train_reference(sz, seed, batches, adamw, device)
    result["checks"] = check.train_numbers(prog, ref)
    result["seconds"] = {"window": window_s,
                         "check": time.perf_counter() - t_check}
    if control:
        low = check.train_reference(sz, seed, batches, adamw, device,
                                    prec=control)
        result["control"] = check.train_numbers(low, ref)
    return result


def _counters() -> dict:
    from repro_torch.runtime.compiled_step import launch_counters
    return {fn.__name__: fn for fn in launch_counters()}


def _record(cell: Cell, tr, calls: dict, host_steps: list) -> Record:
    sz, mix = cell.sizes, cell.traffic
    listed = families.counts(cell.family).train_calls(sz, mix)
    host = {"step_s": host_steps, "profiled_steps": mix["trace"]["steps"],
            "step_flops": FL.train_step_flops(sz, mix["batch"],
                                              mix["seq_len"])}
    return Record(sizes=sz, traffic=mix, trace=tr, host=host,
                  bounds=K.bounds(listed, calls))
