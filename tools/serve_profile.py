#!/usr/bin/env python3
"""Where a decode step's (or a prefill's) time goes: an LM served by the
port on one NVIDIA GPU (``--arch``: granite-3-2b by default, or
mamba2-2.7b or zamba2-1.2b, at full width and depth).

Fills the 4 slots of ``repro_torch.runtime.batcher.ContinuousBatcher``
(512 positions) with prompts of 17, 64, 100 and 128 tokens, runs 5 warm
decode steps, then 10 more under ``torch.profiler`` (CPU and CUDA
activities) and reports per decode step:

- wall ms: the host clock around the steps, ending in a synchronize;
- device ms: the kernels' and copies' time from the profiler's
  ``key_averages()`` (one stream, so their sum is the busy time);
- the device's idle share, ``1 - device / wall``;
- launches: device events per step;
- the kernels by device time, with their launches per step.

Prints one JSON line with the card's ``nvidia-smi`` name and power limit
and writes the full kernel table to ``chiprun_out/serve_profile.json``.
For another ``--arch`` the file is ``serve_profile_<arch>.json``.

With ``--prefill``, profiles instead one B = 1 ``prefill`` of each
served prompt length in ``PREFILL_LENS`` (after 2 warm ones each) and
prints one line per length: wall and device ms, and the device ms and
share of the MLP kernels (names containing ``mlp_``); the table goes to
``serve_profile_prefill[_<arch>].json``.

Both lines carry each LM kernel family's device ms, launches and share
of the device time (``families``: the MLP's, the SSD scan's three
passes, decode attention; the names of earlier builds too, so a run of
an older tree reads the same way).

Run:  python3 tools/serve_profile.py [--arch granite_3_2b] [--prefill]
      [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import card_line  # noqa: E402

PROMPT_LENS = (17, 64, 100, 128)
PREFILL_LENS = (17, 100, 255)     # chip_smoke.py's shortest, middle, longest
N_SLOTS, MAX_LEN = 4, 512
WARM, STEPS = 5, 10
OUT = ROOT / "chiprun_out" / "serve_profile.json"
# kernel family -> substrings of its kernels' names
FAMILIES = {"fused_mlp": ("mlp_",),
            "ssd_scan": ("ssd_kernel", "chunk_pass", "state_pass",
                         "output_pass"),
            "decode_attention": ("decode_kernel", "decode_split_kernel")}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_2b",
                    help="granite_3_2b, mamba2_2p7b or zamba2_1p2b")
    ap.add_argument("--prefill", action="store_true",
                    help="profile B = 1 prefills instead of decode steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    smi, _ = card_line()
    cfg = get_config(args.arch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    rng = np.random.default_rng(args.seed)
    if args.prefill:
        return profile_prefills(torch, profile, ProfilerActivity, M, cfg,
                                params, rng, smi, args.arch)
    batcher = ContinuousBatcher(cfg, params, N_SLOTS, MAX_LEN, device="cuda")
    for i, n in enumerate(PROMPT_LENS):
        batcher.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=WARM + STEPS + 2))
    for _ in range(WARM):
        batcher.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            batcher.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    rows = device_rows(torch, prof, STEPS)
    device_ms = sum(r["ms_per_step"] for r in rows)
    summary = {
        "profile": cfg.name, "slots": N_SLOTS, "max_len": MAX_LEN,
        "steps": STEPS, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if rows else "not measured",
        "idle_share": 1 - device_ms / wall_ms if rows else "not measured",
        "launches_per_step": sum(r["launches_per_step"] for r in rows),
        "families": families(rows), "top": rows[:8], "card": smi}
    print(json.dumps(summary), flush=True)
    out = (OUT if args.arch == "granite_3_2b"
           else OUT.with_name(f"serve_profile_{args.arch}.json"))
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({**summary, "kernels": rows}, indent=1))
    return 0


def families(rows) -> dict:
    """Each kernel family's device ms, launches and share of the device
    time, per step."""
    total = sum(r["ms_per_step"] for r in rows) or 1.0
    out = {}
    for fam, keys in FAMILIES.items():
        mine = [r for r in rows if any(k in r["name"] for k in keys)]
        ms = sum(r["ms_per_step"] for r in mine)
        out[fam] = {"device_ms": ms, "launches": sum(
            r["launches_per_step"] for r in mine), "share": ms / total}
    return out


def device_rows(torch, prof, steps: int) -> list[dict]:
    """The profiled kernels and copies by device time, per step."""
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key[:120], "ms_per_step": us / 1e3
                         / steps, "launches_per_step": evt.count / steps})
    rows.sort(key=lambda r: -r["ms_per_step"])
    return rows


def profile_prefills(torch, profile, activity, M, cfg, params, rng, smi,
                     arch) -> int:
    """One profiled B = 1 prefill per length of PREFILL_LENS."""
    tables = []
    for n in PREFILL_LENS:
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=n),
                           device="cuda", dtype=torch.long)[None]

        def prefill():
            cache = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                                 device="cuda")
            return M.prefill(params, cfg, tok, cache)
        for _ in range(2):
            prefill()
        torch.cuda.synchronize()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_rows(torch, prof, 1)
        device_ms = sum(r["ms_per_step"] for r in rows)
        mlp = [r for r in rows if "mlp_" in r["name"]]
        mlp_ms = sum(r["ms_per_step"] for r in mlp)
        summary = {
            "profile": cfg.name, "prefill_tokens": n, "wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "idle_share": 1 - device_ms / wall_ms if rows else
            "not measured",
            "mlp_device_ms": mlp_ms if rows else "not measured",
            "mlp_launches": sum(r["launches_per_step"] for r in mlp),
            "mlp_share_of_device": mlp_ms / device_ms if rows else
            "not measured",
            "families": families(rows), "top": rows[:6], "card": smi}
        print(json.dumps(summary), flush=True)
        tables.append({**summary, "kernels": rows})
    name = ("serve_profile_prefill.json" if arch == "granite_3_2b"
            else f"serve_profile_prefill_{arch}.json")
    out = OUT.with_name(name)
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(tables, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
