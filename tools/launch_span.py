#!/usr/bin/env python3
"""What a served batch's ``launch`` drift row measures, on the card.

Serves ``--rounds`` bursts of 8 ``unsharp_mask`` frames (512x1024
float32) through ``StreamEngine(max_batch=8, bucket_pad=False,
drift=...)`` and prints, per batch, the row's ``measured_s`` (timing
events around the batch's launches behind the launch gate) and, with
``--profile`` (the serving then runs under ``torch.profiler``), the
group kernel's duration in the profiler's device trace.  Then the same
batched entry on resident frames: by ``CardTimer`` (a spin kernel
queued first, the L2 flushed, best of 10); by a pair of events on an
idle stream after a host gap of 0 and 0.5 ms, without and with a launch
gate in front (without, the pair holds the host's work and the card's
launch latency); and (``--profile``) by the profiler after the card has
idled 0, 2, 10 and 50 ms.  One JSON line each.

Run:  python3 tools/launch_span.py [--rounds 4] [--seed 4] [--profile]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import card_line  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("launch_span: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.apps import build_app
    from repro_torch.kernels.launch_gate import LaunchGate
    from repro_torch.obs.drift import DriftLog
    from repro_torch.runtime import StreamEngine
    from repro_torch.tune.search import CardTimer

    smi, _limit = card_line()
    g = build_app("unsharp_mask", 512, 1024)
    rng = np.random.default_rng(args.seed)
    frames = [rng.standard_normal((512, 1024)).astype(np.float32)
              for _ in range(8)]
    path = os.path.join(tempfile.mkdtemp(), "drift.jsonl")
    prof = profiler(torch) if args.profile else contextlib.nullcontext()
    with prof, StreamEngine(max_batch=8, drift=path,
                            bucket_pad=False) as eng:
        for _ in range(args.rounds):
            hs = [eng.submit(g, {"img": f}) for f in frames]
            for h in hs:
                h.result(timeout=120)
        app = eng.cache.get(g, backend="cuda_stream", device=eng.device)
    torch.cuda.synchronize()
    traced = kernel_us(torch, prof) if args.profile else []
    rows = DriftLog(path).rows()
    for i, r in enumerate(rows):
        print(json.dumps({
            "kind": r.kind, "width": r.attrs.get("width"),
            "batch": r.attrs.get("batch"),
            "row_measured_us": r.measured_s * 1e6,
            "profiler_kernel_us": traced[i] if i < len(traced) else None,
            "modeled_us": r.modeled_s * 1e6, "card": smi}), flush=True)
    fn = app.batch_fn
    xs = torch.from_numpy(np.stack(frames)).cuda()
    print(json.dumps({"resident": "CardTimer: spin first, L2 flushed, "
                      "best of 10",
                      "us": CardTimer()(lambda: fn(xs), reps=10) * 1e6,
                      "card": smi}), flush=True)
    gate = LaunchGate("cuda")
    for gated in (False, True):
        for gap in (0.0, 0.0005):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ticket = gate.hold() if gated else None
            start.record()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < gap:
                pass
            fn(xs)
            end.record()
            if gated:
                gate.release(ticket)
            end.synchronize()
            print(json.dumps({"resident": "idle stream", "gated": gated,
                              "host_gap_s": gap,
                              "us": start.elapsed_time(end) * 1e3,
                              "card": smi}), flush=True)
    if args.profile:
        for idle in (0.0, 0.002, 0.01, 0.05):
            with profiler(torch) as prof:
                fn(xs)
                torch.cuda.synchronize()
                time.sleep(idle)
                fn(xs)
                torch.cuda.synchronize()
            print(json.dumps({"resident": "profiler, after an idle card",
                              "idle_s": idle,
                              "kernel_us": kernel_us(torch, prof),
                              "card": smi}), flush=True)
    return 0


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def kernel_us(torch, prof) -> list:
    """Durations (us) of the group kernels in the profiler's device
    trace, in the order they ran."""
    from torch.autograd import DeviceType
    spans = [(e.time_range.start, e.time_range.elapsed_us())
             for e in prof.events()
             if e.device_type == DeviceType.CUDA and "sg_kernel" in e.name]
    return [us for _t, us in sorted(spans)]


if __name__ == "__main__":
    sys.exit(main())
