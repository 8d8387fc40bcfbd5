"""Quickstart on PyTorch / CUDA: the paper's running example (Section
IV), single-source.  The twin of ``examples/quickstart.py``.

The program below is plain array code: operators for point math,
``fe.conv`` for the local operator.  There is NO DataflowGraph, no
channel, no split anywhere -- tracing extracts the graph (``in_img``
is simply read twice; AutoSplitInsertion makes the fan-out explicit),
the pass pipeline canonicalizes it, convex DAG fusion collapses all
tasks into ONE streaming kernel (the hand-written Hopper group kernel,
generated from the group), and host codegen produces the launcher --
the paper's whole workflow from one decorated function.

Run on the card:   PYTHONPATH=src python examples/quickstart_torch.py
Run on the CPU:    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
(the CPU runs the group kernel's plain PyTorch version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

import repro_torch.frontend as fe
from repro_torch.core.graph import as_dtype
from repro_torch.device import resolve_device


def quickstart_fn(device):
    @fe.dataflow_fn(backend="cuda_stream", device=device)
    def quickstart(in_img):
        fun1 = 2.0 * in_img + 1.0                       # point task
        fun2 = fe.conv(in_img, np.ones((5, 5), np.float32) / 25.0)
        return {"out_img": fun1 - fun2}                 # point task + write
    return quickstart


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    quickstart = quickstart_fn(device)
    H, W = 512, 1024
    x = np.random.default_rng(0).normal(size=(H, W)).astype(np.float32)

    # --- the compiler pipeline ---------------------------------------
    # trace -> canonicalize (auto-split, DCE, point fusion)
    #       -> convex DAG fusion -> lower -> host codegen
    app = quickstart.compile(x)                     # fused group kernel
    print("frontend log:", *app.graph.frontend_log, sep="\n  ")
    print()
    print(app.schedule.describe(), "\n")            # incl. pass log
    print(app.host_program(), "\n")                # generated host

    out = quickstart(x)["out_img"]                  # trace+compile memoized
    ref = app.schedule.graph.reference_eval(
        {"in_img": torch.from_numpy(x).to(device)})["out_img"]
    err = float((out - ref).abs().max())
    print(f"fused-vs-reference max |err| = {err:.2e}")
    # each group input read once, each group output written once
    moved = sum(int(np.prod(c.shape)) * as_dtype(c.dtype).itemsize
                for k in app.kernels
                for c in (*k.group.inputs, *k.group.outputs))
    print(f"device-memory traffic of the fused kernel: {moved/1e6:.1f} MB "
          f"({len(app.kernels)} kernel)")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
