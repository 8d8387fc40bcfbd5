#!/usr/bin/env python3
"""Tile sweep of the port's group kernel on one NVIDIA GPU.

For a few Table-I apps at 1080x1920 float32, times the generated
``cuda_stream`` kernel at every tile of a (th, tw) grid and at the two
automatic choices the compiler could make:

- ``model``: the default, :func:`repro_torch.core.vectorize.select_tile`
  (the cost-model sweep);
- ``largest``: the largest tile that fits shared memory, i.e.
  :func:`~repro_torch.core.vectorize.choose_tile` at the widest vector
  factor the default cap allows.

Times are CUDA events, L2 flushed before each run, median of 20 (the
timer of ``chip_smoke.py``).  Prints one JSON line per app and writes
every tile's time to ``chiprun_out/tile_sweep.json``.

Run:  python3 tools/tile_sweep.py [--seed 0]
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

from chip_smoke import Timer, card_line  # noqa: E402

H, W = 1080, 1920
APPS = ("square", "gaussian_blur", "bilateral_filter", "sobel_luma",
        "filter_chain", "harris", "optical_flow_lk")
HEIGHTS = (8, 16, 32, 64)
WIDTHS = (32, 64, 96, 128, 256)
BUILD_BATCH = 16          # concurrent nvcc processes
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("tile_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.apps import compile_app
    from repro_torch.core.vectorize import DEFAULT_MAX_TILE, LANE
    from repro_torch.kernels import build
    from repro_torch.kernels.stream_group import stream_group

    smi, _ = card_line()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    plans = {}
    for name in APPS:
        cands = {"model": compile_app(name, H, W),
                 "largest": compile_app(
                     name, H, W, vector_factor=DEFAULT_MAX_TILE[1] // LANE)}
        for th in HEIGHTS:
            for tw in WIDTHS:
                cands[f"{th}x{tw}"] = compile_app(
                    name, H, W, vector_factor=tw // LANE, max_tile=(th, tw))
        plans[name] = {label: app.kernels[0] for label, app in cands.items()}
    sources = sorted({k.source for p in plans.values() for k in p.values()})
    for i in range(0, len(sources), BUILD_BATCH):
        build.build_libraries(
            [("sg", s) for s in sources[i:i + BUILD_BATCH]])
    print(f"compiled and built {len(sources)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    timer = Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    for name, kernels in plans.items():
        group = kernels["model"].group
        kin = [torch.randn(c.shape, device="cuda", generator=gen)
               for c in group.inputs]
        by_tile: dict[tuple, float] = {}
        for k in kernels.values():
            if k.tile not in by_tile:
                by_tile[k.tile] = timer(lambda: stream_group(k, kin))
        best = min(by_tile, key=by_tile.get)
        row = {"app": name,
               "model_tile": list(kernels["model"].tile),
               "model_ms": by_tile[kernels["model"].tile],
               "largest_tile": list(kernels["largest"].tile),
               "largest_ms": by_tile[kernels["largest"].tile],
               "best_tile": list(best), "best_ms": by_tile[best],
               "tiles": len(by_tile)}
        print(json.dumps(row), flush=True)
        results[name] = {**row, "all": [
            {"tile": list(t), "ms": ms} for t, ms in sorted(by_tile.items())]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tile_sweep.json").write_text(
        json.dumps({"card": smi, "plane": [H, W], "reps": REPS,
                    "apps": results}, indent=1))
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
