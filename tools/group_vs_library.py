#!/usr/bin/env python3
"""The group kernel against its one-call PyTorch yardstick, in turns.

``chip_smoke.py`` times a kernel, its plain version and its library call
one after the other (20 runs each).  Two functions that take nearly the
same time are compared better in turns: this script times the generated
``cuda_stream`` kernel and the library call of each app that has one
(``torch.square`` for ``square``; ``F.conv2d``, TF32 off, for the four
linear stencils) in alternating order, kernel first in even rounds and
library first in odd ones, each a median of 20 CUDA-event runs with the
L2 flushed before each (the timer of ``chip_smoke.py``), at 1080x1920
float32.  Prints one JSON line per app: the medians, minima and maxima
over the rounds in ms, and in how many rounds the kernel was faster.

Run:  python3 tools/group_vs_library.py [--rounds 8] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (LINEAR_STENCILS, Timer, card_line,  # noqa: E402
                        in_turns, turns_summary)

H, W = 1080, 1920
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("group_vs_library: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.core.apps import compile_app
    from repro_torch.frontend.lib import tables
    from repro_torch.kernels.stream_group import stream_group, stream_group_ref

    torch.backends.cudnn.allow_tf32 = False
    smi, _ = card_line()
    timer = Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name in ("square", *LINEAR_STENCILS):
        (kernel,) = compile_app(name, H, W).kernels
        x = torch.randn(H, W, device="cuda", generator=gen)
        if name == "square":
            library = lambda x=x: torch.square(x)              # noqa: E731
        else:
            w = torch.from_numpy(tables()[LINEAR_STENCILS[name]]).to(
                "cuda")[None, None]
            pad = (w.shape[-2] // 2, w.shape[-1] // 2)
            library = (lambda x=x, w=w, pad=pad:               # noqa: E731
                       F.conv2d(x[None, None], w, padding=pad)[0, 0])
        fns = {"kernel": lambda k=kernel, x=x: stream_group(k, [x]),
               "library": library}
        (want,) = stream_group_ref(kernel.group, [x])
        (got,) = fns["kernel"]()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: kernel differs from its plain version")
        times = in_turns(timer, fns, args.rounds)
        print(json.dumps({
            "app": name, "plane": [H, W], "rounds": args.rounds,
            **turns_summary(times),
            "kernel_faster_rounds": sum(a < b for a, b in
                                        zip(times["kernel"],
                                            times["library"])),
            "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
