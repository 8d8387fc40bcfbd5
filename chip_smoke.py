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
   and, compiled anew, on a ragged 1079x1917 plane (odd width: the
   scalar loads and stores) against the plain version;
4. runs the README quickstart (``@fe.dataflow_fn`` sharpen, 512x1024)
   through the port, checks it against the graph's reference semantics
   on the card;
5. LM serving, granite-3-2b at full width and depth (40 layers, bf16,
   random weights from ``--seed``): holds the three LM kernels
   (flash attention, decode attention, fused MLP; built in phase 2 with
   the group kernels) against their plain versions at the serving
   path's shapes, in float32 (max abs error <= 1e-5 * max|plain|) and
   in the path's types (<= 8e-3 * max|plain|, two bfloat16 steps);
   times kernel, plain version and the library yardstick
   (``F.scaled_dot_product_attention``; the MLP has none, and the bf16
   cuBLAS composition is printed beside it), flash also at S = 2048,
   decode attention at the served lengths (17/130/301/511: it skips the
   masked keys) and with every position live, the MLP at T = 4, 17,
   100, 255 and both sides of its route split; a row timed under its
   bound (share above 1.05) fails, here and in phase 6;
   serves 8
   requests through ``ContinuousBatcher`` (4 slots, 512 positions, 32
   new tokens each), checks the tokens and the launch counts (flash 40
   per prefill, every one on its tensor-core route, decode attention 40
   per decode step, MLP 40 per prefill on its tensor-core route and 40
   per decode step on its decode route; a fused MLP call's launches
   count as one),
   and teacher-forces two requests through ``prefill`` /
   ``decode_step`` with the kernels and with ``impl="ref"``, logits
   within 5e-2 * max|logits|;
6. SSM and hybrid serving: holds the ``ssd_scan`` kernel (built in
   phase 2; three passes a call, counted as one launch) against its
   plain version at mamba2-2.7b's shapes (s = 255, ragged, s = 2048, 16
   chunks of carried state, and s = 128, one chunk; bfloat16 x, B, C)
   and zamba2-1.2b's (s = 200), and in float32 with g = 2 and an
   ``init_state``, its bound counting C B^T once per group and chunk
   and each product at the rate of the 3xTF32 tensor-core passes it
   takes;
   serves 8 requests on mamba2-2.7b at full width and
   depth (64 layers, bf16, random weights from ``--seed``) through the
   4-slot batcher with ``ssd_scan`` launched exactly 64 times per
   prefill (and never at decode); teacher-forces two requests against
   ``impl="ref"`` (logits within twice the spread between two plain
   versions) and one in float32 (within 1e-4 * max|logits|); then frees
   it and serves 4 requests on zamba2-1.2b at full width (38 Mamba2
   layers, 6 shared-attention sites with 32/32 heads), checking every
   kernel's launch count (flash and the MLP on their bf16 routes), and
   teacher-forces one request both ways; the float32 run takes flash
   attention's and the MLP's CUDA-core routes, and flash's is then
   timed at its shape;
7. the ``stream_pipeline`` kernel (built in phase 2), the paper's claim
   in isolation: a chain of pointwise stages over a float32 plane fused
   into one pass against the same kernel run once per stage
   (``stream_pipeline_staged``, one read and one write per stage), at
   1080x1920, 2160x3840 and 4320x7680 (each plane past the 50 MB L2),
   for a chain of 1 stage (``tanh``), 4 (the JAX test's) and 16; fused
   and staged each held against the plain version (max abs error <=
   1e-6 * max|plain|), launched exactly once and once per stage; timed
   with the plain version and, for one stage, ``torch.tanh``; one JSON
   line per case; then C1 against ``torch.tanh`` in turns (8 rounds,
   the kernel first in even rounds) at each plane, and a misaligned
   view checked once;
8. dataflow serving: 96 requests (32 each of ``square``,
   ``unsharp_mask`` and ``optical_flow_lk`` at 1080x1920 float32,
   frames from ``--seed``) submitted interleaved by 4 client threads to
   one ``StreamEngine(max_batch=8, inflight=2, max_queue=64)`` on
   ``cuda_stream``, after one warm-up pass of the same requests; checks
   every result against the app's single-frame launch on the card (max
   abs error 0) and its plain version (1e-6 * max|plain|), 96
   completions, 3 cache misses and no hit, and one group-kernel launch
   per group per batch; prints frames/s, p50/p99, each phase's mean,
   the bucket launches, the pinned copy rates (64 MB, CUDA events) and
   the transfer bound per frame, the same requests served one at a
   time through ``app(**inputs)`` and ``.cpu()``, and for each app one
   launch of B = 8 device-resident frames against 8 single-frame
   launches and its bound (a time under it fails);
9. prints the ``kernels`` line; each route of flash and the MLP has its
   own entries (``flash_attention.tc[...]``, ``fused_mlp.stream[...]``),
   each served app its ``stream_group_b8[...]``.

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
BF16_OPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12          # H100 SXM, TF32 tensor cores, dense
FULL_POWER_W = 700.0
TOL = 1e-6                       # kernel vs plain, relative to max|plain|
LIB_TOL = 1e-5                   # library call vs plain (conv2d reassociates)
REPS = 20                        # timed runs per median
KERNEL_SOURCE = "src/repro_torch/csrc/stream_group.cuh"
REPLACES = "src/repro/core/fusion.py:96"
LINEAR_STENCILS = {"mean_filter": "MEAN5", "gaussian_blur": "GAUSS5",
                   "jacobi": "JACOBI3", "laplace": "LAPLACE3"}
VALID_ROWS_APPS = ("unsharp_mask", "optical_flow_lk")
RAGGED_PLANE = (1079, 1917)      # odd width: scalar loads and stores


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


def in_turns(timer, fns: dict, rounds: int) -> dict:
    """Times each of ``fns`` (label -> call) once a round, the order
    rotated by one each round (for two: the first label first in even
    rounds); returns label -> the rounds' times in ms."""
    labels = list(fns)
    times = {k: [] for k in labels}
    for r in range(rounds):
        k = r % len(labels)
        for label in labels[k:] + labels[:k]:
            times[label].append(timer(fns[label]))
    return times


def turns_summary(times: dict) -> dict:
    """Median, min and max of each label's rounds, in ms."""
    return {f"{k}_ms": {"median": statistics.median(t), "min": min(t),
                        "max": max(t)} for k, t in times.items()}


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
    from repro_torch.kernels.stream_pipeline import PipelineKernel

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
    ragged = {name: compile_app(name, *RAGGED_PLANE)
              for name in VALID_ROWS_APPS}

    @fe.dataflow_fn
    def sharpen(img):
        blur = fe.conv(img, GAUSS3)
        return 2.0 * img - blur

    qs_app = sharpen.compile(fe.spec((QS_H, QS_W)))
    compile_s = time.perf_counter() - t0
    kernels = [k for a in [*apps.values(), *ragged.values(), qs_app]
               for k in a.kernels]
    t0 = time.perf_counter()
    lm_sources = [build.CudaSource(name) for name in LM_KERNELS]
    chains = pipeline_chains(torch)          # fused, and one per stage
    sp_sources = {PipelineKernel(c).source for c in chains.values()} | {
        PipelineKernel((fn,)).source for c in chains.values() for fn in c}
    build.build_libraries([("sg", k.source) for k in kernels]
                          + [(src.name, src.source) for src in lm_sources]
                          + [("sp", src) for src in sorted(sp_sources)])
    print(f"compiled {len(apps) + len(ragged) + 1} apps in {compile_s:.2f} "
          f"s; built "
          f"{len(kernels)} group kernels, {len(lm_sources)} LM kernels and "
          f"{len(sp_sources)} pipeline chains "
          f"in {time.perf_counter() - t0:.2f} s "
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
    for name, app in ragged.items():
        ins = {c.name: torch.randn(c.shape, device="cuda", generator=gen)
               for c in app.schedule.graph.graph_inputs}
        stream_group.launches = 0
        out = app(**ins)
        torch.cuda.synchronize()
        check(stream_group.launches == len(app.schedule.groups),
              f"{name} {RAGGED_PLANE}: {stream_group.launches} launches")
        (kernel,) = app.kernels
        kin = [ins[c.name] for c in kernel.group.inputs]
        outs = [out[c.name] for c in kernel.group.outputs]
        abs_err, rel = rel_err(outs, stream_group_ref(kernel.group, kin))
        check(rel <= TOL, f"{name} {RAGGED_PLANE}: rel err {rel:.3e}")
        print(json.dumps({"app": name, "plane": list(RAGGED_PLANE),
                          "tile": list(kernel.tile),
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

    # -- phase 5: LM serving, granite-3-2b at full width ----------------
    lm_entries = lm_serving(torch, timer, smi, args.seed)

    # -- phase 6: SSM and hybrid serving, mamba2-2.7b and zamba2-1.2b ----
    lm_entries += ssm_serving(torch, timer, smi, args.seed)

    # -- phase 7: stream_pipeline, fused against staged ------------------
    lm_entries += pipeline_phase(torch, timer, smi, power_limit, args.seed,
                                 chains)

    # -- phase 8: dataflow serving through the StreamEngine --------------
    lm_entries += serving_phase(torch, timer, smi, power_limit, args.seed)

    print(json.dumps({"kernels": [
        {"name": f"stream_group[{r['app']}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": r["launches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for r in entries] + lm_entries}),
        flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ----------------------------------------------------------------------
# helpers of the serving phases
# ----------------------------------------------------------------------
def compare_close(torch, name, got, want, tol) -> float:
    """Max abs error of a kernel's output against its plain version;
    fails unless finite and within ``tol * max|want|``."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(bool(torch.isfinite(got.float()).all()) and err <= tol * scale,
          f"{name}: kernel vs plain max abs err {err:.3e} > {tol} * "
          f"{scale:.3e}")
    return err


def lm_bound(n_bytes, n_ops, ops_per_s) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_cases(torch, timer, smi, cases, tol) -> list[dict]:
    """Each (kernel, label, kernel fn, plain fn, library fn or None,
    bound) case: checked against the plain version (and the library
    call against it) and timed; one row each.  A time under the bound
    (share above 1.05) fails: the timing or the bound is wrong."""
    rows = []
    for name, label, kern, plain, library, bnd in cases:
        err = compare_close(torch, f"{name}[{label}]", kern(), plain(), tol)
        row = {"kernel": name, "shape": label, "max_abs_err": err,
               "ms": timer(kern), "plain_ms": timer(plain), **bnd,
               "library_ms": None, "card": smi}
        if library is not None:    # the yardstick must compute the same
            compare_close(torch, f"{name}[{label}] library", library(),
                          plain(), tol)
            row["library_ms"] = timer(library)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        check(row["bound_share"] <= 1.05,
              f"{name}[{label}]: {row['ms']:.5f} ms is under its bound "
              f"{row['bound_ms']:.5f} ms: the timing or the bound is wrong")
        rows.append(row)
    return rows


def kernel_entries(rows, launches) -> list[dict]:
    """Prints each case row with its kernel's launches on the main path
    and returns the rows' entries of the kernels line."""
    entries = []
    for row in rows:
        row["launches"] = launches[row["kernel"]]
        print(json.dumps(row), flush=True)
        base = row["kernel"].split(".")[0]       # flash_attention.tc
        entries.append({
            "name": f"{row['kernel']}[{row['shape']}]", "route": "cuda",
            "source": LM_KERNELS[base][0], "replaces": LM_KERNELS[base][1],
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    return entries


# the routes of flash_attention (tc, simt) and fused_mlp (stream, tc,
# simt), each counted
ROUTES = ("tc", "simt", "stream")


def reset_counts(counters) -> None:
    """Every launch count of ``counters`` (name -> wrapper) to 0."""
    for fn in counters.values():
        fn.launches = 0
        for r in ROUTES:
            if hasattr(fn, f"{r}_launches"):
                setattr(fn, f"{r}_launches", 0)


def read_counts(counters) -> dict:
    """name -> launches, and ``name.route`` -> the route's launches."""
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        for r in ROUTES:
            if hasattr(fn, f"{r}_launches"):
                out[f"{name}.{r}"] = getattr(fn, f"{r}_launches")
    return out


def serve_requests(torch, cfg, params, prompts, new_tokens, counters, smi,
                   init_s, expected) -> tuple[list, dict]:
    """Serves ``prompts`` through a ``ContinuousBatcher`` of N_SLOTS x
    MAX_LEN after a short warm-up, with every launch counter of
    ``counters`` at 0 just before (each route's too); checks the tokens
    and that the counts equal ``expected(prefills, decode_steps)``;
    prints the ``serving``
    line.  Returns (finished requests, launch counts)."""
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    class TimedBatcher(ContinuousBatcher):
        """Records CUDA events around each admission and decode step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefill_events, self.decode_events = [], []

        def _admit(self):
            n0, ev0 = self.prefills, torch.cuda.Event(enable_timing=True)
            ev0.record()
            super()._admit()
            if self.prefills > n0:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                self.prefill_events.append((ev0, ev1, self.prefills - n0))

        def _decode_step(self, tokens, lengths):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = super()._decode_step(tokens, lengths)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            self.decode_events.append((ev0, ev1))
            return out

    warm = ContinuousBatcher(cfg, params, 1, 64, device="cuda")
    warm.submit(Request(rid=-1, prompt=prompts[0][:8], max_new_tokens=3))
    warm.run_to_completion()
    del warm
    batcher = TimedBatcher(cfg, params, N_SLOTS, MAX_LEN, device="cuda")
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    done = batcher.run_to_completion()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    steps = batcher.decode_steps
    check(sorted(r.rid for r in done) == list(range(len(prompts))),
          f"{cfg.name}: {len(done)} of {len(prompts)} requests finished")
    for r in done:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{cfg.name}: request {r.rid} gave {len(r.tokens)} tokens")
    want = expected(batcher.prefills, steps)
    check(launches == want and all(launches[n] for n in counters),
          f"{cfg.name} serving launches {launches}, expected {want}")
    prefill_ms = [a.elapsed_time(b) / n for a, b, n in
                  batcher.prefill_events]
    decode_ms = [a.elapsed_time(b) for a, b in batcher.decode_events]
    decode_tokens = len(prompts) * (new_tokens - 1)
    print(json.dumps({
        "serving": cfg.name, "layers": cfg.n_layers, "slots": N_SLOTS,
        "max_len": MAX_LEN, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "new_tokens": new_tokens,
        "params": cfg.n_params(), "init_s": init_s, "wall_s": wall_s,
        "prefills": batcher.prefills, "decode_steps": steps,
        "launches": launches,
        "prefill_ms_per_request_median": statistics.median(prefill_ms),
        "prefill_ms_per_request": prefill_ms,
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_tokens_per_s": decode_tokens / (sum(decode_ms) / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi}), flush=True)
    return done, launches


def teacher_force(torch, cfg, params, r, smi, tol=None,
                  spread_factor=None) -> None:
    """Feeds request ``r``'s prompt and tokens through ``prefill`` /
    ``decode_step`` with the kernels and with ``impl="ref"``; fails
    unless every step's logits agree within ``tol * max|logits|`` or,
    with ``spread_factor``, within that many times the largest
    difference between two plain versions: ``impl="ref"`` and the same
    with chunks of one position (the scan's token-by-token recurrence),
    which differ only in where they round."""
    import dataclasses

    from repro_torch.models import model as M

    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    routes = {"kernels": cfg, "ref": ref_cfg}
    if spread_factor is not None:
        routes["ref_chunk1"] = dataclasses.replace(ref_cfg, ssm_chunk=1)
    seqs = {}
    for label, c in routes.items():
        cache = M.init_cache(c, 1, MAX_LEN, dtype=torch.float32,
                             device="cuda")
        tok = torch.tensor(r.prompt, device="cuda", dtype=torch.long)
        logits, cache = M.prefill(params, c, tok[None], cache)
        out = [logits[0]]
        for t in r.tokens[:-1]:
            tok = torch.tensor([t], device="cuda")
            logits, cache = M.decode_step(params, c, tok, cache)
            out.append(logits[0])
        seqs[label] = torch.stack(out)
    kern, ref = seqs["kernels"], seqs["ref"]
    err = float((kern - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((ref.argmax(-1).cpu()
                   == torch.tensor(r.tokens)).float().mean())
    row = {"teacher_forced": r.rid, "config": cfg.name, "dtype": cfg.dtype,
           "prompt_len": len(r.prompt), "steps": len(r.tokens),
           "max_abs_dlogits": err, "max_abs_logits": scale}
    if spread_factor is None:
        limit, rule = tol * scale, f"{tol} * max|logits|"
    else:
        spread = float((seqs["ref_chunk1"] - ref).abs().max())
        limit, rule = spread_factor * spread, f"{spread_factor} * spread"
        row["plain_spread"] = spread
    row.update({"tol": limit, "greedy_agree_share": agree, "card": smi})
    print(json.dumps(row), flush=True)
    check(bool(torch.isfinite(kern).all()) and err <= limit,
          f"{cfg.name} ({cfg.dtype}) teacher-forced request {r.rid}: "
          f"kernels vs ref logits {err:.3e} > {rule} = {limit:.3e}")


# ----------------------------------------------------------------------
# phase 5: LM serving
# ----------------------------------------------------------------------
LM_KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:65"),
    "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:64"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:79"),
}
LM_F32_TOL = 1e-5                # kernel vs plain, float32 operands
LM_PATH_TOL = 8e-3               # kernel vs plain, bf16 out: two bf16 steps
# Teacher-forced logits, kernels vs impl="ref", relative to max|logits|.
# Each decode step runs 120 kernel calls whose bf16 outputs round at
# other places than the plain versions' (one bf16 step is 2**-8 = 0.4 %);
# through 40 residual layers such differences add up like a random walk,
# about sqrt(120) * 0.4 % = 4 %, so 5e-2 of the largest logit.
LM_LOGIT_TOL = 5e-2
PROMPT_LENS = (17, 64, 100, 128, 200, 255, 31, 90)
NEW_TOKENS = 32
N_SLOTS, MAX_LEN = 4, 512
FLASH_S = (100, 128, 255, 511)   # served prompts; 511: the batcher's longest
FLASH_LONG_S = 2048              # timed too: where the tensor cores show
# the served lengths (the skip reads 963 of 2048 positions a head), and a
# cache with every position live, so the skip cannot hide a slow full read
DECODE_CASES = {f"{N_SLOTS}x{MAX_LEN}": (17, 130, 301, 511),
                f"{N_SLOTS}x{MAX_LEN} all live": (511,) * N_SLOTS}
MLP_T = (4, 17, 100, 255)        # decode, and served prompt lengths


def lm_serving(torch, timer, smi: str, seed: int) -> list[dict]:
    """Phase 5; returns the LM kernels' entries of the kernels line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_mlp import STREAM_MAX_T, fused_mlp
    from repro_torch.kernels.fused_mlp import route as mlp_route
    from repro_torch.models import model as M

    cfg = get_config("granite_3_2b")
    Hq, Hkv, D, d, f = (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model,
                        cfg.d_ff)
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)

    def randn(*shape, std=1.0, dtype=f32):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * std).to(dtype)

    def compare(name, got, want, tol):
        return compare_close(torch, name, got, want, tol)

    def bound(n_bytes, n_ops):
        return lm_bound(n_bytes, n_ops, BF16_OPS_PER_S)

    # -- kernels against their plain versions, then timed ----------------
    # (kernel, label, kernel fn, plain fn, library fn, bound)
    cases = []
    for S in (*FLASH_S, FLASH_LONG_S):
        q, k, v = (randn(1, S, h, D).transpose(1, 2)
                   for h in (Hq, Hkv, Hkv))          # the model's views
        if S in FLASH_S:
            compare(f"flash_attention[S={S}] f32",
                    flash_attention(q, k, v, causal=True),
                    R.flash_attention_ref(q, k, v, causal=True), LM_F32_TOL)
        qb, kb, vb = (t.to(bf16) for t in (q, k, v))
        pairs = S * (S + 1) // 2
        cases.append((
            "flash_attention.tc", f"S={S}",
            lambda qb=qb, kb=kb, vb=vb: flash_attention(qb, kb, vb,
                                                        causal=True),
            lambda qb=qb, kb=kb, vb=vb: R.flash_attention_ref(qb, kb, vb,
                                                              causal=True),
            lambda qb=qb, kb=kb, vb=vb: F.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True, enable_gqa=True),
            bound(2 * S * D * (2 * Hq + 2 * Hkv), 4 * Hq * D * pairs)))
    q = randn(N_SLOTS, Hq, D)
    k, v = randn(N_SLOTS, Hkv, MAX_LEN, D), randn(N_SLOTS, Hkv, MAX_LEN, D)
    qb = q.to(bf16)                # the path: bf16 query, f32 cache
    for label, lens in DECODE_CASES.items():
        lens = torch.tensor(lens, device="cuda")
        keep = torch.arange(MAX_LEN, device="cuda")[None] <= lens[:, None]
        bias = torch.where(keep, 0.0, -1e30)
        compare(f"decode_attention[{label}] f32",
                decode_attention(q, k, v, bias=bias),
                R.decode_attention_ref(q, k, v, bias=bias), LM_F32_TOL)
        live = int(keep.sum())         # positions the masks keep
        cases.append((
            "decode_attention", label,
            lambda bias=bias: decode_attention(qb, k, v, bias=bias),
            lambda bias=bias: R.decode_attention_ref(qb, k, v, bias=bias),
            lambda bias=bias: F.scaled_dot_product_attention(  # same types
                qb.float()[:, :, None], k, v, attn_mask=bias[:, None, None],
                enable_gqa=True)[:, :, 0],
            bound(2 * N_SLOTS * Hq * D * 2 + live * Hkv * D * 4 * 2
                  + N_SLOTS * MAX_LEN * 4, 4 * Hq * D * live)))
    ws = [randn(d), randn(d, f, std=d ** -0.5),
          randn(d, f, std=d ** -0.5), randn(f, d, std=f ** -0.5)]
    wb = [w.to(bf16) for w in ws]
    cublas = {}                 # the bf16 cuBLAS composition, a yardstick
    # the served lengths and the two sides of the route split
    for T in sorted({*MLP_T, STREAM_MAX_T, STREAM_MAX_T + 1}):
        x = randn(T, d)
        compare(f"fused_mlp[T={T}] f32", fused_mlp(x, *ws),
                R.fused_mlp_ref(x, *ws), LM_F32_TOL)
        xb = x.to(bf16)
        cublas[f"T={T}"] = (
            lambda xb=xb: (F.silu((h := F.rms_norm(xb, (d,), wb[0], 1e-6))
                                  @ wb[1]) * (h @ wb[2])) @ wb[3],
            lambda xb=xb: R.fused_mlp_ref(xb, *wb))
        cases.append((
            f"fused_mlp.{mlp_route(bf16, T, d, f)}", f"T={T}",
            lambda xb=xb: fused_mlp(xb, *wb),
            lambda xb=xb: R.fused_mlp_ref(xb, *wb), None,
            bound(2 * (2 * T * d + d + 3 * d * f), 6 * T * d * f)))

    rows = time_cases(torch, timer, smi, cases, LM_PATH_TOL)
    for row in rows:            # composes three GEMMs: not a library call
        if row["kernel"].startswith("fused_mlp"):
            fn, plain = cublas[row["shape"]]
            compare(f"cuBLAS composition [{row['shape']}]", fn(), plain(),
                    LM_PATH_TOL)
            row["cublas_bf16_ms"] = timer(fn)

    # -- the slice end to end: 8 requests through the batcher ------------
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]

    counters = {"flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_mlp": fused_mlp}
    L = cfg.n_layers
    done, launches = serve_requests(
        torch, cfg, params, prompts, NEW_TOKENS, counters, smi, init_s,
        lambda prefills, steps: {"flash_attention": L * prefills,
                                 "flash_attention.tc": L * prefills,
                                 "flash_attention.simt": 0,
                                 "decode_attention": L * steps,
                                 "fused_mlp": L * (prefills + steps),
                                 "fused_mlp.tc": L * prefills,
                                 "fused_mlp.stream": L * steps,
                                 "fused_mlp.simt": 0})

    # -- teacher forcing: the kernels against impl="ref" -----------------
    by_rid = {r.rid: r for r in done}
    for r in (by_rid[0], by_rid[5]):            # prompts of 17 and 255
        teacher_force(torch, cfg, params, r, smi, tol=LM_LOGIT_TOL)

    return kernel_entries(rows, launches)


# ----------------------------------------------------------------------
# phase 6: SSM and hybrid serving
# ----------------------------------------------------------------------
SSD_CHUNK = 128
# (label, b, s, h, p, g, n, dtype name, init_state): mamba2-2.7b's prefill
# shapes (ragged, 16 chunks of carried state, one chunk), zamba2-1.2b's,
# and a float32 case with g = 2 and a start state
SSD_CASES = (("mamba2 s=255", 1, 255, 80, 64, 1, 128, "bfloat16", False),
             ("mamba2 s=2048", 1, 2048, 80, 64, 1, 128, "bfloat16", False),
             ("mamba2 s=128", 1, 128, 80, 64, 1, 128, "bfloat16", False),
             ("zamba2 s=200", 1, 200, 64, 64, 1, 64, "bfloat16", False),
             ("f32 g=2 init s=300", 1, 300, 80, 64, 2, 128, "float32", True))
ZAMBA_REQUESTS, ZAMBA_NEW_TOKENS = 4, 16
# Teacher-forced logits of the SSM models, kernels vs impl="ref".  Only the
# scan differs between the routes of mamba2 (its decode step is plain
# PyTorch in both); zamba2 adds its 6 attention and MLP sites.  In float32
# the kernels and the plain versions differ in summation order only, about
# 1e-6 of max|y| per call; over 64 layers that grows like a random walk to
# about sqrt(64) * 1e-6 ~ 1e-5 of the largest logit, so 1e-4.  In bfloat16
# each call's output rounds at other places (one bf16 step is 0.4 %), and
# the recurrent state carries those differences on through the layers and
# steps: two plain versions, the chunked scan and the same with chunks of
# one position, already differ by several percent of the largest logit.  So
# in bfloat16 the kernels must stay within twice the plain versions' spread.
SSM_F32_LOGIT_TOL = 1e-4
SSM_SPREAD_FACTOR = 2.0


def ssd_bound(b, s, h, p, g, n, esize, init) -> dict:
    """Bytes: x, B, C and y in their type, dt, A, the start state and the
    final state in float32, each once.  Operations: per batch, group and
    chunk of r rows, the lower triangle of C B^T (r(r+1)/2 x n; the
    heads of a group share it); per head and chunk, the lower triangle
    of the masked product with x dt (r(r+1)/2 x p), the state update (r
    x p x n) and the carried state's contribution (r x n x p; none for
    the first chunk without a start state); two each for a multiply-add.
    The kernel runs every product on the tensor cores in 3xTF32, 495 / 3
    TFLOP/s, with one pass fewer for each operand that is exact in TF32
    (bf16 B and C): in bf16, C B^T at 495 and the two state products at
    495 / 2.  Each product counts at its own rate; the operations' time
    is the sum."""
    n_bytes = (2 * b * s * h * p * esize + b * s * h * 4 + h * 4
               + 2 * b * s * g * n * esize + b * h * p * n * 4 * (2 if init
                                                                  else 1))
    exact = esize == 2                 # bf16 B and C

    def seconds(ops, exact_operands):
        return ops / (TF32_OPS_PER_S / (3 - exact_operands))
    ops = ops_s = 0
    for c0 in range(0, s, SSD_CHUNK):
        r = min(SSD_CHUNK, s - c0)
        tri = r * (r + 1) // 2
        cb = b * g * 2 * tri * n
        masked = b * h * 2 * tri * p
        state = b * h * 2 * r * p * n * (2 if c0 > 0 or init else 1)
        ops += cb + masked + state
        ops_s += (seconds(cb, 2 * exact) + seconds(masked, 0)
                  + seconds(state, exact))
    return lm_bound(n_bytes, ops, ops / ops_s)


def teacher_force_f32(torch, M, cfg, seed, r, smi) -> None:
    """Teacher-forces ``r`` through the model in float32 (weights drawn
    anew from ``seed``), kernels vs ``impl="ref"`` within
    SSM_F32_LOGIT_TOL; frees the card's memory before and after."""
    import dataclasses
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init(f32, torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    teacher_force(torch, f32, params, r, smi, tol=SSM_F32_LOGIT_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def ssm_serving(torch, timer, smi: str, seed: int) -> list[dict]:
    """Phase 6; returns the ``ssd_scan`` entries of the kernels line."""
    import gc

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import model as M

    gc.collect()                       # phase 5's model is gone
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)

    # -- the kernel against its plain version, then timed ---------------
    cases = []
    for label, b, s, h, p, g, n, dname, init in SSD_CASES:
        dtype = getattr(torch, dname)
        x = torch.randn(b, s, h, p, device="cuda", generator=gen).to(dtype)
        dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.19 + 0.01
        A = -(torch.rand(h, device="cuda", generator=gen) * 1.5 + 0.5)
        B = torch.randn(b, s, g, n, device="cuda", generator=gen).to(dtype)
        C = torch.randn(b, s, g, n, device="cuda", generator=gen).to(dtype)
        i0 = (torch.randn(b, h, p, n, device="cuda", generator=gen)
              if init else None)
        args = (x, dt, A, B, C)
        y, fs = ssd_scan(*args, chunk=SSD_CHUNK, init_state=i0)
        yr, fr = R.ssd_ref(*args, chunk=SSD_CHUNK, init_state=i0)
        compare_close(torch, f"ssd_scan[{label}] final state", fs, fr,
                      LM_F32_TOL)
        if dtype == torch.float32:
            compare_close(torch, f"ssd_scan[{label}] y", y, yr, LM_F32_TOL)
        cases.append((
            "ssd_scan", label,
            lambda a=args, i0=i0: ssd_scan(*a, chunk=SSD_CHUNK,
                                           init_state=i0)[0],
            lambda a=args, i0=i0: R.ssd_ref(*a, chunk=SSD_CHUNK,
                                            init_state=i0)[0],
            None, ssd_bound(b, s, h, p, g, n, x.element_size(), init)))
    # y: float32 within 1e-5, bf16 within two bf16 steps of max|plain|
    rows = time_cases(torch, timer, smi, cases, LM_PATH_TOL)

    # -- mamba2-2.7b at full width and depth: 8 requests -----------------
    cfg = get_config("mamba2_2p7b")
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    L = cfg.n_layers
    done, launches = serve_requests(
        torch, cfg, params, prompts, NEW_TOKENS, {"ssd_scan": ssd_scan}, smi,
        init_s, lambda prefills, steps: {"ssd_scan": L * prefills})
    by_rid = {r.rid: r for r in done}
    for r in (by_rid[0], by_rid[5]):            # prompts of 17 and 255
        teacher_force(torch, cfg, params, r, smi,
                      spread_factor=SSM_SPREAD_FACTOR)
    del params
    teacher_force_f32(torch, M, cfg, seed, by_rid[5], smi)

    # -- zamba2-1.2b at full width: 4 requests ----------------------------
    zcfg = get_config("zamba2_1p2b")
    t0 = time.perf_counter()
    params = M.init(zcfg, torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sites = zcfg.n_layers // zcfg.attn_every
    zprompts = [rng.integers(0, zcfg.vocab_size, size=n).astype(np.int32)
                for n in PROMPT_LENS[:ZAMBA_REQUESTS]]
    counters = {"ssd_scan": ssd_scan, "flash_attention": flash_attention,
                "decode_attention": decode_attention, "fused_mlp": fused_mlp}
    zdone, _ = serve_requests(
        torch, zcfg, params, zprompts, ZAMBA_NEW_TOKENS, counters, smi,
        init_s,
        lambda prefills, steps: {"ssd_scan": zcfg.n_layers * prefills,
                                 "flash_attention": sites * prefills,
                                 "flash_attention.tc": sites * prefills,
                                 "flash_attention.simt": 0,
                                 "decode_attention": sites * steps,
                                 "fused_mlp": sites * (prefills + steps),
                                 "fused_mlp.tc": sites * prefills,
                                 "fused_mlp.stream": sites * steps,
                                 "fused_mlp.simt": 0})
    zby_rid = {r.rid: r for r in zdone}       # the prompt of 128
    teacher_force(torch, zcfg, params, zby_rid[3], smi,
                  spread_factor=SSM_SPREAD_FACTOR)
    del params
    # float32 runs flash attention's and the MLP's CUDA-core routes: one
    # prefill, and the MLP at every step
    f32_counters = {"flash_attention": flash_attention,
                    "fused_mlp": fused_mlp}
    reset_counts(f32_counters)
    teacher_force_f32(torch, M, zcfg, seed, zby_rid[3], smi)
    f32_launches = read_counts(f32_counters)
    mlp_calls = sites * len(zby_rid[3].tokens)   # the prefill + each step
    check(f32_launches == {"flash_attention": sites,
                           "flash_attention.tc": 0,
                           "flash_attention.simt": sites,
                           "fused_mlp": mlp_calls, "fused_mlp.tc": 0,
                           "fused_mlp.stream": 0,
                           "fused_mlp.simt": mlp_calls},
          f"zamba2 float32 launches {f32_launches}")
    S, Hq, D = len(zby_rid[3].prompt), zcfg.n_heads, zcfg.hd
    q, k, v = (torch.randn(1, S, h, D, device="cuda", generator=gen)
               .transpose(1, 2) for h in (Hq, zcfg.n_kv_heads,
                                          zcfg.n_kv_heads))
    compare_close(torch, f"flash_attention.simt[zamba2 S={S} f32]",
                  flash_attention(q, k, v, causal=True),
                  R.flash_attention_ref(q, k, v, causal=True), LM_F32_TOL)
    simt_rows = time_cases(torch, timer, smi, [(
        "flash_attention.simt", f"zamba2 S={S} f32",
        lambda: flash_attention(q, k, v, causal=True),
        lambda: R.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        lm_bound(4 * S * D * (2 * Hq + 2 * zcfg.n_kv_heads),
                 4 * Hq * D * S * (S + 1) // 2, FP32_OPS_PER_S))],
        LM_PATH_TOL)

    return (kernel_entries(rows, launches)
            + kernel_entries(simt_rows, f32_launches))


# ----------------------------------------------------------------------
# phase 7: stream_pipeline, fused against staged
# ----------------------------------------------------------------------
PIPELINE_SOURCE = "src/repro_torch/csrc/stream_pipeline.cuh"
PIPELINE_REPLACES = "src/repro/kernels/stream_pipeline.py:34"
# full HD (the apps' plane), 4K UHD and 8K UHD: 16.6, 66 and 265 MB moved
PIPELINE_PLANES = ((1080, 1920), (2160, 3840), (4320, 7680))
PIPELINE_TURNS = 8               # rounds of C1 against torch.tanh


def pipeline_chains(torch) -> dict:
    """Stage count -> chain: ``tanh``; the JAX test's chain
    (tests/test_kernels.py), run on |x|; that chain four times."""
    c4 = (torch.tanh, lambda v: v * 2.0, torch.abs, torch.sqrt)
    return {1: (torch.tanh,), 4: c4, 16: c4 * 4}


def pipeline_close(torch, name, got, want) -> float:
    """Max abs error, NaN where the plain version has NaN; fails unless
    within TOL * max|want|."""
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    same_nan = torch.equal(torch.isnan(got), nan)
    diff = (got - want).abs().masked_fill(nan, 0.0)
    err = float(diff.max())
    scale = float(want.abs().masked_fill(nan, 0.0).max())
    check(same_nan and err <= TOL * scale,
          f"{name}: vs plain max abs err {err:.3e} > {TOL} * {scale:.3e} "
          f"(NaN where the plain version has NaN: {same_nan})")
    return err


def pipeline_phase(torch, timer, smi: str, power_limit: float, seed: int,
                   chains: dict) -> list[dict]:
    """Phase 7; returns the ``stream_pipeline`` entries of the kernels
    line."""
    import gc

    import repro_torch.kernels.stream_pipeline as sp

    gc.collect()                       # phase 6's models are gone
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    props = torch.cuda.get_device_properties(0)
    entries = []
    for Hp, Wp in PIPELINE_PLANES:
        x = torch.randn(Hp, Wp, device="cuda", generator=gen)
        xa = x.abs()
        for stages, fns in chains.items():
            xin = x if stages == 1 else xa
            label = f"{Hp}x{Wp},{stages}"
            # the main path: the entry point a user calls, counter from 0
            sp.stream_pipeline.launches = 0
            out = sp.stream_pipeline(xin, fns)
            torch.cuda.synchronize()
            launches = sp.stream_pipeline.launches
            check(launches == 1, f"stream_pipeline[{label}]: {launches} "
                  f"launches, expected 1")
            sp.stream_pipeline.launches = 0
            staged = sp.stream_pipeline_staged(xin, fns)
            torch.cuda.synchronize()
            staged_launches = sp.stream_pipeline.launches
            check(staged_launches == stages,
                  f"stream_pipeline_staged[{label}]: {staged_launches} "
                  f"launches, expected {stages}")
            check(tuple(out.shape) == (Hp, Wp) and out.is_cuda
                  and out.dtype == torch.float32,
                  f"stream_pipeline[{label}]: output {tuple(out.shape)} "
                  f"{out.dtype}")
            ref = sp.stream_pipeline_ref(xin, fns)
            err = pipeline_close(torch, f"stream_pipeline[{label}]", out, ref)
            staged_err = pipeline_close(
                torch, f"stream_pipeline_staged[{label}]", staged, ref)
            library = None
            if stages == 1:            # one PyTorch call computes it
                pipeline_close(torch, f"torch.tanh[{label}]",
                               torch.tanh(xin), ref)
                library = timer(lambda: torch.tanh(xin))
            del out, staged, ref
            n_bytes = 2 * 4 * Hp * Wp
            kernel = sp.PipelineKernel(fns)
            ops = kernel.ops_per_element() * Hp * Wp
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / FP32_OPS_PER_S * 1e3
            row = {"kernel": "stream_pipeline", "plane": [Hp, Wp],
                   "stages": stages, "unroll": sp.unroll(
                       kernel.cost_per_element(), Hp * Wp,
                       props.multi_processor_count, props.L2_cache_size),
                   "ms": timer(lambda: sp.stream_pipeline(xin, fns)),
                   "staged_ms": timer(
                       lambda: sp.stream_pipeline_staged(xin, fns)),
                   "plain_ms": timer(lambda: sp.stream_pipeline_ref(xin, fns)),
                   "library_ms": library, "bytes": n_bytes,
                   "staged_bytes": stages * n_bytes, "ops": ops,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "max_abs_err": err, "staged_max_abs_err": staged_err,
                   "launches": launches, "staged_launches": staged_launches}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["staged_over_fused"] = row["staged_ms"] / row["ms"]
            if power_limit < FULL_POWER_W:
                row["bound_ms_power_scaled"] = (row["bound_ms"]
                                                * FULL_POWER_W / power_limit)
            row["card"] = smi
            print(json.dumps(row), flush=True)
            check(row["bound_share"] <= 1.05,
                  f"stream_pipeline[{label}]: {row['ms']:.5f} ms is under "
                  f"its bound {row['bound_ms']:.5f} ms: the timing is wrong")
            entries.append({
                "name": f"stream_pipeline[{label}]", "route": "cuda",
                "source": PIPELINE_SOURCE, "replaces": PIPELINE_REPLACES,
                "launches": launches, "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": library})
        del x, xa
        gc.collect()
        torch.cuda.empty_cache()

    # C1 against torch.tanh in turns: the two are within a few percent,
    # closer than sequential timing resolves
    for Hp, Wp in PIPELINE_PLANES:
        x = torch.randn(Hp, Wp, device="cuda", generator=gen)
        times = in_turns(timer, {
            "kernel": lambda x=x: sp.stream_pipeline(x, chains[1]),
            "library": lambda x=x: torch.tanh(x)}, PIPELINE_TURNS)
        print(json.dumps({
            "kernel": "stream_pipeline", "case": "C1 in turns",
            "plane": [Hp, Wp], "rounds": PIPELINE_TURNS,
            **turns_summary(times),
            "kernel_faster_rounds": sum(a < b for a, b in zip(
                times["kernel"], times["library"])), "card": smi}),
            flush=True)
        del x

    # a view whose data is not 16-byte aligned takes the scalar loads
    Hp, Wp = PIPELINE_PLANES[0]
    fns = chains[4]
    flat = torch.randn(Hp * Wp + 1, device="cuda", generator=gen).abs()
    xm = flat[1:].view(Hp, Wp)
    check(xm.is_contiguous() and xm.data_ptr() % 16 != 0,
          "the misaligned case is aligned")
    ref = sp.stream_pipeline_ref(xm, fns)
    err = pipeline_close(torch, "stream_pipeline[misaligned]",
                         sp.stream_pipeline(xm, fns), ref)
    staged_err = pipeline_close(torch, "stream_pipeline_staged[misaligned]",
                                sp.stream_pipeline_staged(xm, fns), ref)
    print(json.dumps({"kernel": "stream_pipeline", "case": "misaligned view",
                      "plane": [Hp, Wp], "stages": 4,
                      "data_ptr_mod_16": xm.data_ptr() % 16,
                      "max_abs_err": err, "staged_max_abs_err": staged_err}),
          flush=True)
    return entries



# ----------------------------------------------------------------------
# phase 8: dataflow serving
# ----------------------------------------------------------------------
SERVE_APPS = ("square", "unsharp_mask", "optical_flow_lk")
SERVE_PER_APP = 32
SERVE_CLIENTS = 4
SERVE_BATCH = 8
COPY_BYTES = 64 * 2**20          # the copy-rate probe


def copy_rates(torch) -> dict:
    """Pinned host-to-device and device-to-host rates (bytes/s) of one
    64 MB copy; the pageable ``.cpu()`` the engine reads back with (new
    host memory each call), and a pageable copy into host memory that
    was written before, by CUDA events (median of 5 after one warm
    copy)."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    touched = torch.zeros(COPY_BYTES, dtype=torch.uint8)

    def rate(fn):
        fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        return COPY_BYTES / statistics.median(times)

    return {"h2d_pinned": rate(lambda: dev.copy_(host, non_blocking=True)),
            "d2h_pinned": rate(lambda: host.copy_(dev, non_blocking=True)),
            "d2h_pageable": rate(lambda: dev.cpu()),
            "d2h_pageable_reused": rate(lambda: touched.copy_(dev))}


def serving_phase(torch, timer, smi: str, power_limit: float,
                  seed: int) -> list[dict]:
    """Phase 8; returns the ``stream_group_b8`` entries of the kernels
    line."""
    import gc
    import threading

    import numpy as np

    from repro_torch.core.apps import build_app
    from repro_torch.kernels.stream_group import stream_group, stream_group_ref
    from repro_torch.runtime import PHASES, StreamEngine

    t_phase = time.perf_counter()
    gc.collect()                       # phase 7's planes are gone
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 19)
    graphs = {n: build_app(n, H, W) for n in SERVE_APPS}
    reqs = [(n, {c.name: rng.standard_normal(c.shape, dtype=np.float32)
                 for c in graphs[n].graph_inputs})
            for _ in range(SERVE_PER_APP) for n in SERVE_APPS]

    def serve(eng) -> tuple[list, float]:
        """All requests, interleaved over the client threads; returns
        the results in request order and the wall time."""
        handles = [None] * len(reqs)

        def client(k):
            for i in range(k, len(reqs), SERVE_CLIENTS):
                n, x = reqs[i]
                handles[i] = eng.submit(graphs[n], x)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [h.result(timeout=300) for h in handles]
        return results, time.perf_counter() - t0

    with StreamEngine(max_batch=SERVE_BATCH, inflight=2,
                      max_queue=64) as eng:
        serve(eng)                     # warm: pinned buffers, libraries
        apps = {n: eng.cache.get(g, backend="cuda_stream", device=eng.device)
                for n, g in graphs.items()}
        warm = eng.report()            # flushes the warm pass's telemetry
        eng.telemetry.reset()
        batches0 = {n: a["batches"] for n, a in warm["apps"].items()}
        buckets0 = dict(warm["buckets"])
        # the main path: the engine a user calls, counter from 0
        stream_group.launches = 0
        results, wall_s = serve(eng)
        torch.cuda.synchronize()
        launches = stream_group.launches
        rep = eng.report()
    m = rep["measured"]
    batches = {n: rep["apps"][n]["batches"] - batches0[n] for n in SERVE_APPS}
    buckets = {w: n - buckets0.get(w, 0) for w, n in rep["buckets"].items()
               if n - buckets0.get(w, 0)}
    groups = {n: len(apps[n].schedule.groups) for n in SERVE_APPS}
    check(m["completed"] == len(reqs),
          f"serving: {m['completed']} of {len(reqs)} completed")
    check(rep["cache"]["misses"] == len(SERVE_APPS)
          and rep["cache"]["hits"] == 0,
          f"serving: cache {rep['cache']}, expected 3 misses and no hit")
    want = sum(batches[n] * groups[n] for n in SERVE_APPS)
    check(launches == want and sum(buckets.values()) == sum(batches.values()),
          f"serving: {launches} group-kernel launches for {batches} batches "
          f"(groups {groups}; buckets {buckets}), expected {want}")
    check(m["latency_p50_ms"] <= m["latency_p99_ms"],
          f"serving: p50 {m['latency_p50_ms']} > p99 {m['latency_p99_ms']}")

    # each result: equal to the single-frame launch, close to the plain
    # version; the single-frame pass is the one-at-a-time yardstick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = [{k: v.cpu() for k, v in apps[n](**x).items()} for n, x in reqs]
    single_s = time.perf_counter() - t0
    worst = {n: 0.0 for n in SERVE_APPS}
    for (n, x), got, one in zip(reqs, results, single):
        (kernel,) = apps[n].kernels
        plain = stream_group_ref(
            kernel.group, [torch.from_numpy(x[c.name]).cuda()
                           for c in kernel.group.inputs])
        for c, ref in zip(kernel.group.outputs, plain):
            g = torch.from_numpy(got[c.name])
            check(torch.equal(g, one[c.name]),
                  f"serving {n}: a result differs from the app's single-"
                  f"frame launch")
            ref = ref.cpu()
            err = float((g - ref).abs().max())
            check(err <= TOL * float(ref.abs().max()),
                  f"serving {n}: result vs plain max abs err {err:.3e}")
            worst[n] = max(worst[n], err)
    del single

    rates = copy_rates(torch)
    plane = 4 * H * W
    transfer = {n: (len(graphs[n].graph_inputs) * plane / rates["h2d_pinned"]
                    + len(graphs[n].graph_outputs) * plane
                    / rates["d2h_pinned"]) * 1e3 for n in SERVE_APPS}
    mix_ms = sum(transfer.values()) / len(SERVE_APPS)
    line = {"serving": "dataflow", "apps": list(SERVE_APPS),
            "plane": [H, W], "requests": len(reqs),
            "clients": SERVE_CLIENTS, "max_batch": SERVE_BATCH,
            "inflight": 2, "frames_per_s": len(reqs) / wall_s,
            "wall_s": wall_s, "throughput_rps": m["throughput_rps"],
            "p50_ms": m["latency_p50_ms"], "p99_ms": m["latency_p99_ms"],
            "phase_mean_ms": {p: m["phases"][p]["mean_ms"] for p in PHASES},
            "service_ewma_ms": m["service_ewma_ms"],
            "batch_size_mean": m["batch_size_mean"],
            "batches": batches, "bucket_launches": buckets,
            "group_launches": launches, "cache": rep["cache"],
            "max_abs_err_vs_plain": worst, "card": smi}
    print(json.dumps(line), flush=True)
    print(json.dumps({
        "serving": "transfer", "copy_bytes": COPY_BYTES,
        **{f"{k}_GBps": v / 1e9 for k, v in rates.items()},
        "transfer_bound_ms_per_frame": transfer,
        "transfer_bound_frames_per_s_mix": 1e3 / mix_ms,
        "served_over_bound": (wall_s / len(reqs)) / (mix_ms * 1e-3),
        "card": smi}), flush=True)
    print(json.dumps({
        "serving": "one at a time", "requests": len(reqs),
        "frames_per_s": len(reqs) / single_s, "wall_s": single_s,
        "engine_over_single": single_s / wall_s, "card": smi}), flush=True)

    # one launch of 8 device-resident frames per app, against 8
    # single-frame launches and its bound
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    entries = []
    for n in SERVE_APPS:
        (kernel,) = apps[n].kernels
        xs = [torch.randn(SERVE_BATCH, H, W, device="cuda", generator=gen)
              for _ in kernel.group.inputs]
        outs = stream_group(kernel, xs)
        refs = stream_group_ref(kernel.group, xs)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(outs, refs)
        check(rel <= TOL, f"stream_group_b8[{n}]: rel err {rel:.3e}")
        for b in range(SERVE_BATCH):
            one = stream_group(kernel, [x[b] for x in xs])
            check(all(torch.equal(o[b], s) for o, s in zip(outs, one)),
                  f"stream_group_b8[{n}]: frame {b} differs from its "
                  f"single-frame launch")
        n_bytes = (SERVE_BATCH * plane
                   * (len(kernel.group.inputs) + len(kernel.group.outputs)))
        ops = SERVE_BATCH * kernel.ops_per_element() * H * W
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        library = None
        if n == "square":              # one PyTorch call computes it
            _, lib_rel = rel_err([torch.square(xs[0])], refs)
            check(lib_rel <= LIB_TOL, f"torch.square b8: {lib_rel:.3e}")
            library = timer(lambda: torch.square(xs[0]))
        frame = [x[0] for x in xs]
        row = {"kernel": "stream_group_b8", "app": n, "frames": SERVE_BATCH,
               "plane": [H, W], "launches": batches[n] * groups[n],
               "max_abs_err": abs_err, "max_rel_err": rel,
               "ms": timer(lambda: stream_group(kernel, xs)),
               "single_frame_ms": timer(lambda: stream_group(kernel, frame)),
               "plain_ms": timer(lambda: stream_group_ref(kernel.group, xs)),
               "library_ms": library, "bytes": n_bytes, "ops": ops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        row["over_8_single"] = row["ms"] / (SERVE_BATCH
                                            * row["single_frame_ms"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if power_limit < FULL_POWER_W:
            row["bound_ms_power_scaled"] = (row["bound_ms"] * FULL_POWER_W
                                            / power_limit)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        check(row["bound_share"] <= 1.05,
              f"stream_group_b8[{n}]: {row['ms']:.5f} ms is under its "
              f"bound {row['bound_ms']:.5f} ms: the timing is wrong")
        entries.append({
            "name": f"stream_group_b8[{n}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": row["launches"], "max_abs_err": abs_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library})
        del xs, outs, refs
    print(json.dumps({"serving": "phase 8",
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    return entries


if __name__ == "__main__":
    sys.exit(main())
