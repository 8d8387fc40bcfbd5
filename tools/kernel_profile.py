#!/usr/bin/env python3
"""Device time of ``decode_attention`` and of each pass of ``ssd_scan``
under ``torch.profiler``, at ``chip_smoke.py``'s shapes, on one NVIDIA GPU.

``chip_smoke.py`` times each kernel call from outside (CUDA events, L2
flushed); this tool splits a call into its launches: the ``ssd_scan``
call's chunk pass (C B^T tiles and each chunk's own end state), state pass
and output pass, and the single ``decode_attention`` launch.  It runs each
case 3 times to warm up, then 5 times under the profiler, and prints one
JSON line per case with the mean device microseconds of each kernel per
call, beside the card's ``nvidia-smi`` name and power limit.

With ``--cuts``, also profiles the scan at mamba2-2.7b's s = 2048 built
from edited copies of ``csrc/ssd_scan.cu`` (wrong outputs, timing only):
``no_products`` without any tensor-core product, ``no_carried`` without
the output pass's carried-state tile (its loads and product), and both;
what a pass loses in each is what that part costs it.

Run:  python3 tools/kernel_profile.py [--seed 0] [--cuts]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import DECODE_CASES, MAX_LEN, N_SLOTS, SSD_CASES, SSD_CHUNK  # noqa: E402
from chip_smoke import card_line  # noqa: E402

# the kernels of a call, by a part of their names
PARTS = ("decode_split_kernel", "chunk_pass", "state_pass", "output_pass")
RUNS = 5
# edits of csrc/ssd_scan.cu for --cuts: (pattern, replacement) pairs
PRODUCTS = (r"warp_mma<[^;]*;", "")
CARRIED = (r"if \(prev != nullptr\) \{", "if (false) {")
CUTS = {"no_products": (PRODUCTS,), "no_carried": (CARRIED,),
        "no_products_no_carried": (PRODUCTS, CARRIED)}


def per_kernel_us(torch, fn) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        for part in PARTS:
            if part in evt.key and us > 0:
                out[part] = out.get(part, 0.0) + us / RUNS
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cuts", action="store_true",
                    help="also time the scan with parts cut out")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.kernels.ssd_scan as SK
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    smi, _ = card_line()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cfg = get_config("granite_3_2b")
    q = torch.randn(N_SLOTS, cfg.n_heads, cfg.hd, device="cuda",
                    generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(N_SLOTS, cfg.n_kv_heads, MAX_LEN, cfg.hd,
                        device="cuda", generator=gen) for _ in range(2))
    for label, lens in DECODE_CASES.items():
        keep = (torch.arange(MAX_LEN, device="cuda")[None]
                <= torch.tensor(lens, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, -1e30)
        us = per_kernel_us(
            torch, lambda bias=bias: decode_attention(q, k, v, bias=bias))
        print(json.dumps({"kernel": "decode_attention", "shape": label,
                          "device_us": us, "card": smi}), flush=True)
    for label, b, s, h, p, g, n, dname, init in SSD_CASES:
        dtype = getattr(torch, dname)
        x = torch.randn(b, s, h, p, device="cuda", generator=gen).to(dtype)
        dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.19 + 0.01
        A = -(torch.rand(h, device="cuda", generator=gen) * 1.5 + 0.5)
        B, C = (torch.randn(b, s, g, n, device="cuda", generator=gen)
                .to(dtype) for _ in range(2))
        i0 = (torch.randn(b, h, p, n, device="cuda", generator=gen)
              if init else None)
        us = per_kernel_us(torch, lambda: ssd_scan(
            x, dt, A, B, C, chunk=SSD_CHUNK, init_state=i0))
        print(json.dumps({"kernel": "ssd_scan", "shape": label,
                          "device_us": us,
                          "total_us": sum(us.values()), "card": smi}),
              flush=True)
        if args.cuts and label == "mamba2 s=2048":
            profile_cuts(torch, build, SK, smi, lambda: ssd_scan(
                x, dt, A, B, C, chunk=SSD_CHUNK, init_state=i0))
    return 0


def profile_cuts(torch, build, SK, smi, call) -> None:
    """Times ``call`` with the scan built from each edit of CUTS."""
    real = SK._SOURCE
    sources = {}
    for name, edits in CUTS.items():
        text = real.source
        for pattern, repl in edits:
            text, hits = re.subn(pattern, repl, text)
            if not hits:
                raise RuntimeError(f"--cuts: {pattern!r} no longer applies")
        sources[name] = text
    build.build_libraries([("ssd_scan", t) for t in sources.values()])
    try:
        for name, text in sources.items():
            SK._SOURCE = edited_source(build, "ssd_scan", text)
            us = per_kernel_us(torch, call)
            print(json.dumps({"kernel": "ssd_scan", "shape": "mamba2 s=2048",
                              "cut": name, "device_us": us,
                              "total_us": sum(us.values()), "card": smi}),
                  flush=True)
    finally:
        SK._SOURCE = real


def edited_source(build, name: str, text: str):
    """A ``build.CudaSource`` of kernel ``name`` whose text is ``text``."""
    class Source(build.CudaSource):
        source = property(lambda self: text)
    return Source(name)


if __name__ == "__main__":
    sys.exit(main())
