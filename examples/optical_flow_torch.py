"""Lucas-Kanade optical flow on PyTorch / CUDA -- the paper's Fig. 4
16-stage pipeline.  The twin of ``examples/optical_flow.py``.

The LK graph (derivatives, products, windowed sums, 2x2 solve) is a
*traced single-source program*: ``repro_torch.core.apps.optical_flow_lk``
is plain array code (``it = f2 - f1``, ``ixx = ix * ix``, ``fe.conv``,
...) that the frontend extracts into the dataflow graph -- every split
stage below was inserted automatically.  The pass pipeline
canonicalizes it, convex DAG fusion collapses all 16 stages into one
streaming kernel (the hand-written Hopper group kernel), and the
example estimates motion on a synthetic translating pattern, its
result held against ``reference_eval``.  Demonstrates memory-bundle
assignment across the parallel DAG paths (the paper's mem1..4).

Run on the card:   PYTHONPATH=src python examples/optical_flow_torch.py
Run on the CPU:    PYTHONPATH=src python examples/optical_flow_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from repro_torch.core import build_schedule, compile_graph
from repro_torch.core.apps import optical_flow_lk
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    H, W = 256, 512
    g = optical_flow_lk(H, W)          # traced from plain array code
    sched = build_schedule(g)
    n_split = sum(1 for s in sched.graph.stages if s.kind == "split")
    print(f"LK graph: {len(sched.graph.stages)} tasks "
          f"({len(sched.graph.stages) - n_split} compute + {n_split} "
          f"auto-inserted splits), fused into {len(sched.groups)} "
          f"kernel(s) by convex DAG fusion")
    print("memory bundles:",
          {c.name: f"mem{b}" for c, b in sched.bundles.items()})

    # synthetic scene: smooth random texture translated by (dy, dx)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(H + 8, W + 8)).astype(np.float32)
    k = np.ones((9, 9), np.float32) / 81.0
    smooth = sliding_window_view(base, (9, 9)).reshape(H, W, 81) @ k.ravel()
    dy, dx = 1, 1   # LK linearizes: keep sub-2px motion
    f1 = np.ascontiguousarray(smooth[: H - 4, : W - 4], np.float32)
    f2 = np.ascontiguousarray(smooth[dy: H - 4 + dy, dx: W - 4 + dx],
                              np.float32)

    # the app is built at the frame size
    g2 = optical_flow_lk(*f1.shape, eps=1e-8)
    app = compile_graph(g2, backend="cuda_stream", device=device)
    ins = {"f1": torch.from_numpy(f1).to(device),
           "f2": torch.from_numpy(f2).to(device)}
    out = app(**ins)
    ref = app.schedule.graph.reference_eval(ins)
    err = max(float((out[n] - ref[n]).abs().max()) for n in ("vx", "vy"))
    scale = max(float(ref[n].abs().max()) for n in ("vx", "vy"))
    print(f"fused-vs-reference max |err| = {err:.2e} (max |v| {scale:.2e})")
    assert err <= 1e-5 * scale
    vx = out["vx"].cpu().numpy()[16:-16, 16:-16]
    vy = out["vy"].cpu().numpy()[16:-16, 16:-16]
    # convention: f2(y,x) = f1(y+dy, x+dx) shifts content by (-dy,-dx),
    # so LK should report flow ~= (-dx, -dy).
    print(f"estimated flow: vx median={np.median(vx):+.2f} (true {-dx}), "
          f"vy median={np.median(vy):+.2f} (true {-dy})")
    ok = (abs(np.median(vx) + dx) < 0.75
          and abs(np.median(vy) + dy) < 0.75)
    print("OK" if ok else "flow estimate out of tolerance")
    assert ok


if __name__ == "__main__":
    main()
