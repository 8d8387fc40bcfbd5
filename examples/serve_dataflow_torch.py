"""Serve a compiled dataflow app with the port's StreamEngine.

The PyTorch / CUDA twin of ``examples/serve_dataflow.py``: the same
diamond app served as a long-lived *service*.  Requests flow through a
bounded FIFO, same-topology requests hit the compile cache instead of
re-tracing, consecutive requests are micro-batched into one launch of
the group kernel for the whole batch, and two batches stay in flight
at once (double buffering).  At the end the engine prints its
telemetry next to the Fig. 1 analytic prediction.

Run on the card:   PYTHONPATH=src python examples/serve_dataflow_torch.py
Run on the CPU:    PYTHONPATH=src python examples/serve_dataflow_torch.py --device cpu
(the CPU serves the plain PyTorch versions of the kernels).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import DataflowGraph
from repro_torch.frontend.lib import JACOBI3, LAPLACE3, conv_taps
from repro_torch.runtime import StreamEngine


def diamond(h: int, w: int) -> DataflowGraph:
    """split -> two stencil branches -> merge (fuses to ONE kernel)."""
    g = DataflowGraph("diamond")
    x = g.input("x", (h, w))
    s1 = g.stencil(x, (3, 3), conv_taps(LAPLACE3), name="lap")
    s2 = g.stencil(x, (3, 3), conv_taps(JACOBI3), name="jac")
    g.output(g.point2(s1, s2, lambda u, v: u - v, name="merge"), "y")
    return g


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    H, W, N = 48, 256, 32
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(H, W)).astype(np.float32) for _ in range(N)]
    g = diamond(H, W)

    with StreamEngine(device=args.device, max_batch=8, max_queue=64) as eng:
        # submit the whole stream; each handle is a future
        handles = [eng.submit(g, {"x": f}) for f in frames]
        results = [h.result(timeout=300) for h in handles]
        report = eng.report()
        app = eng.cache.get(g, backend="cuda_stream", device=eng.device)

    # every request is bit-exact against the reference oracle
    ref_graph = app.schedule.graph
    for f, r in zip(frames, results):
        ref = ref_graph.reference_eval(
            {"x": torch.from_numpy(f).to(eng.device)})["y"]
        np.testing.assert_array_equal(r["y"], ref.cpu().numpy())
    print(f"{N} requests served on {eng.device}, all bit-exact vs "
          f"reference_eval\n")

    m = report["measured"]
    print("measured:")
    print(f"  completed          {m['completed']}")
    print(f"  throughput         {m['throughput_rps']:.1f} req/s")
    print(f"  latency p50 / p99  {m['latency_p50_ms']:.1f} / "
          f"{m['latency_p99_ms']:.1f} ms")
    print(f"  mean queue depth   {m['queue_depth_mean']:.1f}")
    print(f"  mean batch size    {m['batch_size_mean']:.1f}")
    print("  phases (mean ms)   " + ", ".join(
        f"{p} {v['mean_ms']:.3f}" for p, v in m["phases"].items()))
    c = report["cache"]
    print(f"cache: {c['misses']} compile for {c['requests']} requests")
    mod = report["modeled"]["diamond"]
    print("modeled (Fig. 1, cycles):")
    print(f"  sequential {mod['sequential']:.0f}  dataflow "
          f"{mod['dataflow']:.0f}  speedup {mod['speedup']:.2f}x")
    assert c["misses"] == 1 and c["requests"] == N
    print("OK")


if __name__ == "__main__":
    main()
