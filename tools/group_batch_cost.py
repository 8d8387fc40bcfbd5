#!/usr/bin/env python3
"""What the group kernel's batch axis would cost a single frame, in turns.

Every generated group kernel takes a batch of ``B`` frames in one launch
(``gridDim.z = B``): the kernel's batch instance first moves each
block's input and output pointers to frame ``blockIdx.z``, and one frame
launches the instance without that offset.  This script builds each of
the 13 Table-I apps' kernels at 1080x1920 float32 twice, as generated
and with the launcher edited to take the batch instance for one frame
too, checks that both give the plain version's planes bit for bit, and
times the two on one frame in alternating order (generated first in
even rounds), each a median of 20 CUDA-event runs with the L2 flushed
before each (the timer of ``chip_smoke.py``).  Prints one JSON line per
app: the medians, minima and maxima over the rounds in ms, and in how
many rounds the generated kernel was faster.

Run:  python3 tools/group_batch_cost.py [--rounds 8] [--seed 0]
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import Timer, card_line, in_turns, turns_summary  # noqa: E402

H, W = 1080, 1920
REPS = 20
DISPATCH = "  if (B > 1) {"


def batch_instance_always(kernel):
    """A copy of ``kernel`` whose launcher takes the batch instance for
    one frame too (built anew at its first launch)."""
    if kernel.source.count(DISPATCH) != 1:
        raise RuntimeError("the launcher's batch dispatch is not in the "
                           "source")
    batched = copy.copy(kernel)
    batched.source = kernel.source.replace(DISPATCH, "  if (B > 0) {")
    batched._fn = batched._lib = None
    return batched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("group_batch_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.apps import APPS, compile_app
    from repro_torch.kernels import build
    from repro_torch.kernels.stream_group import stream_group_ref

    smi, _ = card_line()
    timer = Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    pairs = {}
    for name in APPS:
        (kernel,) = compile_app(name, H, W).kernels
        pairs[name] = (kernel, batch_instance_always(kernel))
    build.build_libraries([("sg", k.source) for p in pairs.values()
                           for k in p])
    for name, (kernel, batched) in pairs.items():
        xs = [torch.randn(H, W, device="cuda", generator=gen)
              for _ in kernel.group.inputs]
        want = stream_group_ref(kernel.group, xs)
        for k in (kernel, batched):
            got = k.launch(xs, None)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name}: a build differs from the plain "
                                   f"version")
        times = in_turns(timer, {
            "generated": lambda k=kernel, xs=xs: k.launch(xs, None),
            "batch_instance": lambda k=batched, xs=xs: k.launch(xs, None)},
            args.rounds)
        print(json.dumps({
            "app": name, "plane": [H, W], "rounds": args.rounds,
            **turns_summary(times),
            "generated_faster_rounds": sum(a < b for a, b in zip(
                times["generated"], times["batch_instance"])),
            "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
