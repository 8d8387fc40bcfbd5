"""Runs one cell of ``BENCHMARK.json`` once on this machine's GPU.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout of the repository.  It builds the port's
kernels where they are not built yet (under ``build/repro_torch/`` in
the checkout), makes the weights and inputs from ``--seed``, warms up,
measures for ``--seconds`` seconds, checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and with ``--trace 1`` its busy and window
seconds and a ``breakdown``), and last ``checks``: each number compared
with its limit, which also close standard error.

It exits with 2 and prints no result where the host lacks the GPUs the
cell asks for, and with 3 where JAX or the JAX package got loaded.
Every cache it writes lies in fixed directories inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    base = ROOT / "build" / "bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench.harness import cell as C
    from bench.harness.runner import forbidden_modules, run_cell, SHARE_LIMIT

    cell = C.load(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this host has {have}", file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    over = {k: v["value"] for k, v in line["metrics"].items()
            if ("_roofline" in k or "mfu" in k) and v["value"] > SHARE_LIMIT}
    if over:
        print(f"bench: shares above {SHARE_LIMIT} %, a fault of their "
              f"counts: {over}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
