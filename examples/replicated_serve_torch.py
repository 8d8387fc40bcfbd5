"""Serve one dataflow app with BOTH hardware-parallelism axes, on the port.

The PyTorch / CUDA twin of ``examples/replicated_serve.py``.  FLOWER's
transformation taxonomy widens a processing element (*vectorization*)
and duplicates it (*replication*).  This example runs the same compiled
stencil chain three ways and prints the telemetry side by side:

1. plain compiled app — the vector-factor sweep picks the tile,
2. spatially replicated app — the plane row-partitioned over k replicas
   with halo exchange (``replicate_app``),
3. replicated serving farm — ``StreamEngine(replicas=k)`` shards each
   padded micro-batch across the replicas.

The replicas are the host's cards when it has several; ``--replicas k``
on a host with fewer cards places the k replicas on the first card
(the replicated app only: the engine's farm takes one card a replica).
On the CPU (``--device cpu``) the k replicas are k copies of the CPU,
each running the plain PyTorch versions of the kernels.

Run on the card:   PYTHONPATH=src python examples/replicated_serve_torch.py
Run on the CPU:    PYTHONPATH=src python examples/replicated_serve_torch.py --device cpu --replicas 4
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import compile_graph
from repro_torch.core.apps import build_app
from repro_torch.device import resolve_device
from repro_torch.parallel import replicate_app
from repro_torch.runtime import StreamEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--replicas", type=int, default=None,
                    help="replica count (default: every card, or 4 on "
                         "the CPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    H, W, N = 96, 256, 32
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    k = args.replicas or (cards or 4)
    if H % k:
        raise SystemExit(f"--replicas {k} does not divide the {H}-row plane")
    # one card stands for every replica it lacks (the replicated app)
    devices = ([torch.device("cuda", j if j < cards else 0)
                for j in range(k)] if cards else [dev] * k)
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(H, W)).astype(np.float32) for _ in range(N)]

    g = build_app("filter_chain", H, W)
    app = compile_graph(build_app("filter_chain", H, W), device=dev)
    print("=== compiled app (auto vector-factor sweep) ===")
    print(app.schedule.describe(), "\n")

    print(f"=== spatial replication over {k} replica(s) ===")
    rapp = replicate_app(app, k, devices=devices)
    print(rapp.describe().splitlines()[0])
    print(rapp.describe().splitlines()[1])
    ref = app(img=frames[0])["out"]
    out = rapp(img=frames[0])["out"]
    assert torch.equal(out, ref)
    print("replicated output bit-exact vs single-device: True\n")

    farm = k if not cards or cards >= k else 1
    print(f"=== serving farm: StreamEngine(replicas={farm}) ===")
    with StreamEngine(device=dev, max_batch=8 * farm, replicas=farm,
                      max_queue=N) as eng:
        handles = [eng.submit(g, {"img": f}) for f in frames]
        results = [h.result(timeout=300) for h in handles]
        report = eng.report()
    for f, r in zip(frames, results):
        np.testing.assert_array_equal(r["out"],
                                      app(img=f)["out"].cpu().numpy())
    m = report["measured"]
    print(f"  completed              {m['completed']}")
    print(f"  throughput             {m['throughput_rps']:.1f} req/s "
          f"({m['throughput_per_replica_rps']:.1f} per replica)")
    print(f"  latency p50 / p99      {m['latency_p50_ms']:.1f} / "
          f"{m['latency_p99_ms']:.1f} ms")
    modeled = next(iter(report["modeled"].values()))
    if "replica_scaling_modeled" in modeled:
        print(f"  modeled farm scaling   "
              f"{modeled['replica_scaling_modeled']:.2f}x "
              f"(linear would be {farm}x)")
    print("\nall outputs bit-exact across every parallel mode: OK")


if __name__ == "__main__":
    main()
