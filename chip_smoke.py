#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA GPU and fails (nonzero exit,
no result line) on any error:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. compiles the 13 Table-I apps at 1080x1920 float32 with the defaults
   (device ``cuda``, backend ``cuda_stream``) and the README quickstart,
   and builds every generated group kernel from the repo's sources,
   one nvcc per kernel, all at once;
3. per app: runs the compiled app once with the launch counter at 0 and
   checks one launch per fusion group and finite outputs of the right
   shape; holds the kernel against its plain PyTorch version on the
   card (max abs error <= 1e-6 * max|plain|); times the kernel, the
   plain version and the ``torch_staged`` backend with CUDA events
   (warmed up, L2 flushed before each run, median of 20), and as the
   library yardstick ``F.conv2d`` (TF32 off) for the single
   linear-stencil apps and ``torch.square`` for ``square``; prints the byte and operation bounds; one JSON
   line per app.  Two apps also run with ``valid_rows=(5, 1070)``
   against the plain version;
4. runs the README quickstart (``@fe.dataflow_fn`` sharpen, 512x1024)
   through the port, checks it against the graph's reference semantics
   on the card, and prints the ``kernels`` line.

The last line is ``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H, W = 1080, 1920
QS_H, QS_W = 512, 1024
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, float32 outside tensor cores
FULL_POWER_W = 700.0
TOL = 1e-6                       # kernel vs plain, relative to max|plain|
LIB_TOL = 1e-5                   # library call vs plain (conv2d reassociates)
REPS = 20                        # timed runs per median
KERNEL_SOURCE = "src/repro_torch/csrc/stream_group.cuh"
REPLACES = "src/repro/core/fusion.py:96"
LINEAR_STENCILS = {"mean_filter": "MEAN5", "gaussian_blur": "GAUSS5",
                   "jacobi": "JACOBI3", "laplace": "LAPLACE3"}
VALID_ROWS_APPS = ("unsharp_mask", "optical_flow_lk")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> tuple[str, float]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    limit = float(out.split(",")[-1].strip().split()[0])
    return out, limit


class Timer:
    """Device time of one call: CUDA events around it, with a spin
    kernel queued first so the host's enqueue time is hidden, and the
    L2 cache flushed before each run (a frame arrives cold)."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = int(max(2e-3, 3 * enqueue_s) * 2e9)   # cycles at <= 2 GHz
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bounds(kernel, n_bytes: int) -> dict:
    H_, W_ = kernel.plane
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops = kernel.ops_per_element() * H_ * W_
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def rel_err(outs, refs) -> tuple[float, float]:
    abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return abs_err, abs_err / max(scale, 1e-30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch.frontend as fe
    from repro_torch.core.apps import APPS, compile_app
    from repro_torch.frontend.lib import GAUSS3, tables
    from repro_torch.kernels import build
    from repro_torch.kernels.stream_group import stream_group, stream_group_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card ----------------------------------------------
    smi, power_limit = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind}", flush=True)

    # -- phase 2: compile and build --------------------------------------
    t0 = time.perf_counter()
    apps = {name: compile_app(name, H, W) for name in APPS}

    @fe.dataflow_fn
    def sharpen(img):
        blur = fe.conv(img, GAUSS3)
        return 2.0 * img - blur

    qs_app = sharpen.compile(fe.spec((QS_H, QS_W)))
    compile_s = time.perf_counter() - t0
    kernels = [k for a in [*apps.values(), qs_app] for k in a.kernels]
    t0 = time.perf_counter()
    build.build_libraries([k.source for k in kernels])
    print(f"compiled {len(apps) + 1} apps in {compile_s:.2f} s; built "
          f"{len(kernels)} kernels in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)

    timer = Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = []

    def library_call(name, kin):
        """One PyTorch call that computes the app, where there is one."""
        if name == "square":
            return lambda: torch.square(kin[0])
        if name not in LINEAR_STENCILS:
            return None
        x = kin[0][None, None]
        taps = tables()[LINEAR_STENCILS[name]]
        w = torch.from_numpy(taps).to("cuda")[None, None]
        pad = (w.shape[-2] // 2, w.shape[-1] // 2)
        return lambda: torch.nn.functional.conv2d(x, w, padding=pad)[0, 0]

    def run_app(label, app, ins):
        g = app.schedule.graph
        # the main path: the entry point a user calls, counter from 0
        stream_group.launches = 0
        out = app(**ins)
        torch.cuda.synchronize()
        launches = stream_group.launches
        check(launches == len(app.schedule.groups),
              f"{label}: {launches} kernel launches for "
              f"{len(app.schedule.groups)} fusion groups")
        for ch in g.graph_outputs:
            o = out[ch.name]
            check(tuple(o.shape) == ch.shape and o.is_cuda
                  and bool(torch.isfinite(o).all()),
                  f"{label}: output {ch.name} is not finite {ch.shape} on "
                  f"the card")
        (kernel,) = app.kernels
        kin = [ins[c.name] for c in kernel.group.inputs]
        outs = stream_group(kernel, kin)
        refs = stream_group_ref(kernel.group, kin)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(outs, refs)
        check(rel <= TOL, f"{label}: kernel vs plain rel err {rel:.3e}")
        ms = timer(lambda: stream_group(kernel, kin))
        plain_ms = timer(lambda: stream_group_ref(kernel.group, kin))
        n_bytes = (4 * kernel.plane[0] * kernel.plane[1]
                   * (len(kernel.group.inputs) + len(kernel.group.outputs)))
        row = {"app": label, "plane": list(kernel.plane),
               "tile": list(kernel.tile), "smem_bytes": kernel.smem_bytes,
               "launches": launches, "max_abs_err": abs_err,
               "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               **bounds(kernel, n_bytes)}
        if power_limit < FULL_POWER_W:
            row["bound_ms_power_scaled"] = (row["bound_ms"] * FULL_POWER_W
                                            / power_limit)
        row["bound_share"] = row["bound_ms"] / ms
        row["library_ms"] = None
        library = library_call(label, kin)
        if library is not None:
            _, lib_rel = rel_err([library()], refs)
            check(lib_rel <= LIB_TOL,
                  f"{label}: the library call disagrees ({lib_rel:.3e})")
            row["library_ms"] = timer(library)
        return row

    # -- phase 3: the 13 apps --------------------------------------------
    for name, app in apps.items():
        ins = {c.name: torch.randn(c.shape, device="cuda", generator=gen)
               for c in app.schedule.graph.graph_inputs}
        row = run_app(name, app, ins)
        staged = compile_app(name, H, W, backend="torch_staged")
        row["torch_staged_ms"] = timer(lambda: staged(**ins))
        print(json.dumps(row), flush=True)
        entries.append(row)
        if name in VALID_ROWS_APPS:
            (kernel,) = app.kernels
            kin = [ins[c.name] for c in kernel.group.inputs]
            rows = (5, 1070)
            outs = stream_group(kernel, kin, rows)
            refs = stream_group_ref(kernel.group, kin, rows)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(outs, refs)
            check(rel <= TOL, f"{name} valid_rows={rows}: rel err {rel:.3e}")
            check(all(float(o[:5].abs().max()) == 0.0 for o in outs),
                  f"{name} valid_rows={rows}: rows above the band not zero")
            print(json.dumps({"app": name, "valid_rows": list(rows),
                              "max_abs_err": abs_err, "max_rel_err": rel}),
                  flush=True)

    # -- phase 4: the README quickstart through @fe.dataflow_fn ----------
    x = torch.randn(QS_H, QS_W, device="cuda", generator=gen)
    stream_group.launches = 0
    y = sharpen(x)
    torch.cuda.synchronize()
    check(stream_group.launches == 1, "quickstart: expected one launch")
    ref = qs_app.schedule.graph.reference_eval({"img": x})["out"]
    _, rel = rel_err([y], [ref])
    check(rel <= TOL, f"quickstart vs reference_eval: rel err {rel:.3e}")
    row = run_app("sharpen", qs_app, {"img": x})
    print(json.dumps(row), flush=True)
    entries.append(row)

    print(json.dumps({"kernels": [
        {"name": f"stream_group[{r['app']}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": r["launches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for r in entries]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
