#!/usr/bin/env python3
"""``stream_pipeline``'s unroll against chain weight and plane size, in
turns, on one NVIDIA GPU.

For each chain (``--stages``: 1 is ``tanh``; a multiple of 4 repeats
the JAX test's four-stage chain ``tanh, *2, abs, sqrt`` on |x|, as
``chip_smoke.py``'s C4 and C16 do) and each plane (1080x1920, 2160x3840,
4320x7680 float32), times the shipped kernel (its unroll from
``unroll``) beside launches of the same library at each of
``--unrolls`` (the float4 loads a thread issues before the chain runs)
and, for the one-stage chain, ``torch.tanh``.  Timing is
``chip_smoke.py``'s timer (CUDA events, L2 flushed before each run,
median of 20), every function
once a round in an order rotated by one each round.  Every launch is
first checked bit-exact against the plain chain.  Prints one JSON line
per chain and plane: the shipped unroll, the medians, minima and maxima
over the rounds, and for every other function the rounds in which it
beat the shipped kernel.

Run:  python3 tools/pipeline_variants.py [--stages 1,4,8,12,16]
      [--unrolls 1,2,4] [--rounds 8]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (PIPELINE_PLANES, Timer, card_line,  # noqa: E402
                        in_turns, turns_summary)


def chain(torch, stages: int) -> tuple:
    """``tanh`` for one stage, else the four-stage chain repeated."""
    if stages == 1:
        return (torch.tanh,)
    if stages % 4:
        raise ValueError(f"--stages: 1 or a multiple of 4, got {stages}")
    return (torch.tanh, lambda v: v * 2.0, torch.abs, torch.sqrt) * (
        stages // 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", default="1,4,16")
    ap.add_argument("--unrolls", default="1,2,4")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("pipeline_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.launch import sm_count
    from repro_torch.kernels.stream_pipeline import (PipelineKernel,
                                                     stream_pipeline,
                                                     stream_pipeline_ref,
                                                     unroll)

    smi, _ = card_line()
    timer = Timer(torch, 20)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    unrolls = [int(u) for u in args.unrolls.split(",")]
    chains = {s: chain(torch, s)
              for s in (int(s) for s in args.stages.split(","))}
    kernels = {s: PipelineKernel(fns) for s, fns in chains.items()}
    build.build_libraries([("sp", k.source) for k in kernels.values()])
    n_sm = sm_count(0)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size

    for stages, fns in chains.items():
        k = kernels[stages]
        for H, W in PIPELINE_PLANES:
            shipped = unroll(k.cost_per_element(), H * W, n_sm, l2)
            x = torch.randn(H, W, device="cuda", generator=gen)
            if stages > 1:
                x = x.abs()
            calls = {"kernel": lambda x=x: stream_pipeline(x, fns)}
            calls.update({f"u{u}": (lambda x=x, u=u: k.launch(x, u))
                          for u in unrolls})
            if stages == 1:
                calls["library"] = lambda x=x: torch.tanh(x)
            want = stream_pipeline_ref(x, fns)
            for label, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{label} at {H}x{W}, {stages} "
                                       f"stages, differs from the plain "
                                       f"chain")
            times = in_turns(timer, calls, args.rounds)
            print(json.dumps({
                "plane": [H, W], "stages": stages,
                "cost": k.cost_per_element(), "shipped_unroll": shipped,
                "rounds": args.rounds, **turns_summary(times),
                "beat_kernel_rounds": {
                    f: sum(a < b for a, b in zip(t, times["kernel"]))
                    for f, t in times.items() if f != "kernel"},
                "card": smi}), flush=True)
            del x, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
