"""Readings that the limits of ``correct`` are set from, for one cell,
on this machine's GPU, in one process.

    python3 bench/calibrate.py --workload <name> [--seeds 12]
        [--control-seeds 3] [--seconds 15] [--first-seed N] [--faults]

For each of ``--seeds`` seeds it runs the cell as ``bench/run.py`` does
(untraced, ``--seconds`` long) and prints the numbers compared; for the
first ``--control-seeds`` it also reads the control, the reference
computed in fp8 put in the program's place (serving: the gap of the
token fp8 puts first, and what one altered token reads).  With
``--faults`` (training cells) it reads, on the control seeds, the
program with half of each batch left out (the loss the mean over the
rest).  One JSON line per reading, the control's beside
``control_correct``, the control judged under the cell's limits file as
it stands; the readings go to that file by hand, with the limit chosen
between them.

``--sweep 3,4,5`` (serving cells) instead sends the cell's requests as
an open loop (:func:`open_loop`) at each of those rates, requests a
second, and prints each rate's tokens/s, time to first token and
backlog: the sweep that finds the highest rate the system sustains.
No cell runs the open loop; it lives here, not in the driver.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def open_loop(closed: type, rate: float, seed: int) -> type:
    """The serving driver's ``Loop`` (``closed``) turned open: from the
    end of set-up's warm steps, requests are sent at the times of a
    Poisson process at ``rate`` a second drawn from the seed, whatever
    has finished, each timed from when it was due (a late send counts);
    a finished request sends nothing."""
    import numpy as np

    class OpenLoop(closed):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps, self.next_due = 0, None
            self.rng = np.random.default_rng([seed, 4])

        def finished(self, t: float) -> None:
            pass

        def step(self):
            self.steps += 1
            now = time.perf_counter()
            if self.steps > self.requests.mix["warm_steps"]:
                if self.next_due is None:
                    self.next_due = now + self.rng.exponential(1.0 / rate)
                while self.next_due <= now:
                    self.send(self.next_due)
                    self.next_due += self.rng.exponential(1.0 / rate)
            return super().step()
    return OpenLoop


def half_batch_fault(set_attr=setattr) -> None:
    """Plants the fault: the train step sees the first half of each
    batch only (``set_attr``: how to replace the step's builder, e.g. a
    test's ``monkeypatch.setattr``)."""
    from repro_torch.runtime import steps

    real = steps.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def halved(state, batch):
            half = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return halved
    set_attr(steps, "make_train_step", make)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--sweep", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import cell as C
    from bench.harness.runner import run_cell

    cell = C.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.sweep:
        from bench.drivers import serve
        closed = serve.Loop
        for rate in (float(r) for r in args.sweep.split(",")):
            serve.Loop = open_loop(closed, rate, args.first_seed)
            line = run_cell(cell, args.first_seed, args.seconds, False, dev,
                            time.perf_counter())
            print(json.dumps({"workload": cell.name, "rate_per_s": rate,
                              "metrics": {k: v["value"] for k, v in
                                          line["metrics"].items()},
                              "load": line["load"],
                              "attempted": line["attempted"]}), flush=True)
            torch.cuda.empty_cache()
        serve.Loop = closed
        return 0
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        ctl = "fp8" if i < args.control_seeds else None
        t0 = time.perf_counter()
        line = run_cell(cell, seed, args.seconds, False, dev, t0,
                        control=ctl)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "checks": {k: v["value"] for k, v in
                                     line["checks"].items()},
                          "control": line.get("control"),
                          "control_correct": line.get("control_correct"),
                          "metrics": {k: v["value"] for k, v in
                                      line["metrics"].items()},
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if args.faults and cell.traffic["kind"] == "train":
        half_batch_fault()
        for seed in seeds[:args.control_seeds]:
            line = run_cell(cell, seed, 1.0, False, dev, time.perf_counter())
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "fault": "half_batch",
                              "checks": {k: v["value"] for k, v in
                                         line["checks"].items()}}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
