#!/usr/bin/env python3
"""``fused_mlp``'s routes and plans against each other on one NVIDIA GPU.

At granite-3-2b's width (d 2048, d_ff 8192, bf16, random weights with
std d^-1/2), times with ``chip_smoke.py``'s timer (CUDA events, L2
flushed before each run, median of 20):

- the split between the decode route and the tensor-core route: both
  at T = 1, 2, 4 and 8 (the decode route's rows), the tensor-core route
  also at 16, 32 and 64, in turns (``--rounds`` rounds);
- the tensor-core route's cut at the served prompt lengths 17, 100 and
  255: 64 or 128 rows a block and d_ff slices of 64 to 512 columns, each
  with a ring of 3, 4 and 5 stages (a build each, its ``STAGES``
  edited in the source text), the plan's own cut and ring marked
  ``chosen``;
- the CUDA-core route in bf16 (the kernel of the PR that ported it),
  the plain version and the bf16 cuBLAS composition (``F.rms_norm``,
  three bf16 matmuls, ``silu`` * mul) at T = 4, 17, 100 and 255;
- with ``--cases diagnose`` (not by default): what holds the tensor-core
  route back, from two builds of ``fused_mlp.cu`` edited on the fly, one
  with each ``mma.sync`` replaced by one dependent float add (the
  fragments are still loaded) and one with every ``cp.async`` copy of
  the tensor-core kernel removed (it multiplies stale shared memory),
  timed beside the real kernel at T = 17, 100 and 255.  Their outputs
  are wrong by design and are not checked.

Every kernel call is first held against the plain version (8e-3 x
max|plain|).  Prints one JSON line per case and writes them all to
``chiprun_out/mlp_sweep.json``.

Run:  python3 tools/mlp_sweep.py [--rounds 4] [--cases split,plan,baselines]
      [--seed 0]
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (LM_PATH_TOL, Timer, card_line,  # noqa: E402
                        compare_close, in_turns)

D, F_ = 2048, 8192
SPLIT_T = (1, 2, 4, 8, 16, 32, 64)
PLAN_T = (17, 100, 255)
PLANS = ((1, 64), (1, 128), (1, 256), (2, 64), (2, 128), (2, 256))
STAGES = (3, 4, 5)
BASE_T = (4, 17, 100, 255)
OUT = ROOT / "chiprun_out" / "mlp_sweep.json"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--cases", default="split,plan,baselines",
                    help="comma-separated: split, plan, baselines, "
                         "diagnose")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("mlp_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import ref as R

    torch.backends.cuda.matmul.allow_tf32 = False
    smi, _ = card_line()
    timer = Timer(torch, 20)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * std).to(bf16)
    ws = [randn(D), randn(D, F_, std=D ** -0.5), randn(D, F_, std=D ** -0.5),
          randn(F_, D, std=F_ ** -0.5)]
    xs = {T: randn(T, D) for T in sorted({*SPLIT_T, *PLAN_T, *BASE_T})}

    def call(which, T):
        return lambda: FM.launch_route(which, xs[T], *ws, 1e-6)

    def checked(label, fn, T):
        compare_close(torch, label, fn(), R.fused_mlp_ref(xs[T], *ws),
                      LM_PATH_TOL)
        return fn

    rows = []

    def emit(row):
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)

    cases = args.cases.split(",")
    # the decode route against the tensor-core route, in turns
    for T in SPLIT_T if "split" in cases else ():
        fns = {"tc": checked(f"tc T={T}", call("tc", T), T)}
        if T <= FM.STREAM_MAX_T:
            fns["stream"] = checked(f"stream T={T}", call("stream", T), T)
        times = in_turns(timer, fns, args.rounds)
        emit({"case": "split", "T": T, "route": FM.route(bf16, T, D, F_),
              **{f"{k}_ms": statistics.median(t) for k, t in times.items()}})

    # the tensor-core route's cut and ring depth
    builds = {st: ring_source(FM._SOURCE.source, st)
              for st in STAGES if "plan" in cases}
    build.build_libraries([("fused_mlp", b) for b in builds.values()])
    tc_fns = {st: tc_launcher(build, FM, b) for st, b in builds.items()}
    for T in PLAN_T if "plan" in cases else ():
        chosen = FM.tc_plan(T, F_, FM.sm_count(0))
        for (mt, fs), st in itertools.product(PLANS, STAGES):
            if FM.tc_smem_bytes(mt, fs, st) > FM.SMEM_LIMIT:
                continue
            p = FM.TcPlan(mt, fs, -(-F_ // fs))
            fn = checked(f"tc T={T} {p} stages={st}", lambda T=T, p=p, st=st:
                         tc_call(torch, tc_fns[st], xs[T], ws, p), T)
            emit({"case": "tc_plan", "T": T, "mt": mt, "fs": fs,
                  "stages": st, "nsplit": p.nsplit,
                  "blocks": -(-T // (64 * mt)) * p.nsplit,
                  "partial_mb": p.nsplit * T * D * 8 / 1e6,
                  "ms": timer(fn),
                  "chosen": p == chosen and st == FM._TC_STAGES})

    # the CUDA-core route, the plain version and the cuBLAS composition
    for T in BASE_T if "baselines" in cases else ():
        x = xs[T]
        wn, wg, wu, wd = ws

        def cublas(x=x):
            h = F.rms_norm(x, (D,), wn, 1e-6)
            return (F.silu(h @ wg) * (h @ wu)) @ wd
        simt = checked(f"simt T={T}", call("simt", T), T)
        compare_close(torch, f"cublas T={T}", cublas(),
                      R.fused_mlp_ref(x, *ws), LM_PATH_TOL)
        emit({"case": "baselines", "T": T, "chosen_route":
              FM.route(bf16, T, D, F_),
              "chosen_ms": timer(call(FM.route(bf16, T, D, F_), T)),
              "simt_bf16_ms": timer(simt),
              "plain_ms": timer(lambda x=x: R.fused_mlp_ref(x, *ws)),
              "cublas_bf16_ms": timer(cublas)})

    if "diagnose" in cases:
        fns = {k: tc_launcher(build, FM, v)
               for k, v in diagnose_sources(FM._SOURCE.source).items()}
        for T in PLAN_T:
            emit({"case": "diagnose", "T": T,
                  **{f"{k}_ms": timer(lambda T=T, fn=fn: tc_call(
                      torch, fn, xs[T], ws, FM.tc_plan(T, F_, FM.sm_count(0))))
                     for k, fn in fns.items()}})

    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    return 0


def tc_launcher(build, FM, source: str):
    """``fused_mlp_tc_launch`` of a build of ``source``."""
    fn = build.load_library("fused_mlp", source).fused_mlp_tc_launch
    fn.argtypes, fn.restype = FM._TC_ARGTYPES, ctypes.c_int
    return fn


def tc_call(torch, fn, x, ws, p):
    """The tensor-core route through ``fn`` (a build's
    ``fused_mlp_tc_launch``) cut by plan ``p``: ``launch_route``'s
    tensor-core branch with the library and the plan as arguments."""
    from repro_torch.kernels.launch import stream_of
    T, d = x.shape
    xn = torch.empty((T, d), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((p.nsplit, T, d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    rc = fn(*(t.data_ptr() for t in (x, *ws, xn, partial, out)), T, d,
            ws[1].shape[1], 1e-6, p.mt, p.fs, stream_of(x.device))
    if rc != 0:
        raise RuntimeError(f"fused_mlp_tc_launch failed ({rc})")
    return out


def ring_source(src: str, stages: int) -> str:
    """``fused_mlp.cu`` with a ring of ``stages`` slots in the
    tensor-core kernel; raises if the edit no longer applies."""
    line = "constexpr int STAGES = 3;"
    if line not in src:
        raise RuntimeError("ring_source: the ring edit no longer applies")
    return src.replace(line, f"constexpr int STAGES = {stages};")


def diagnose_sources(src: str) -> dict:
    """The real source and its two diagnostic edits (see the docstring);
    raises if an edit no longer applies."""
    from repro_torch.kernels import build
    header = (build.CSRC_DIR / "tensor_core.cuh").read_text()
    start = header.index("  asm volatile(\n      \"mma.sync")
    mma = header[start:header.index(");\n", start) + 3]
    no_mma = header.replace(
        mma, "  c[0] += __int_as_float((a[0] ^ b0) & 0x3f800000u);\n")
    copies = ("      cp_async16(slot + r * LDK + ch, valid ? src : xn, valid);",
              "      cp_async16(slot + r * LDD + ch,\n"
              "                 valid ? wd + (long long)row * a.d + col : wd,"
              " valid);")
    no_copy = src
    for c in copies:
        if c not in no_copy:
            raise RuntimeError("diagnose: the copy edit no longer applies")
        no_copy = no_copy.replace(c, "      (void)valid;")
    out = {"tc": src,
           "tc_no_mma": src.replace('#include "tensor_core.cuh"',
                                    no_mma.replace("#pragma once", "")),
           "tc_no_copy": no_copy}
    build.build_libraries([("fused_mlp", v) for v in out.values()])
    return out


if __name__ == "__main__":
    sys.exit(main())
