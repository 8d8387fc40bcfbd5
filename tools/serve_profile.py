#!/usr/bin/env python3
"""Where a decode step's (or a prefill's) time goes: an LM served by the
port on one NVIDIA GPU (``--arch``: granite-3-2b by default, or
mamba2-2.7b, zamba2-1.2b, granite-moe-3b-a800m, minicpm3-4b, whisper-base
or internvl2-26b, at full width and depth).

Fills the 4 slots of ``repro_torch.runtime.batcher.ContinuousBatcher``
(512 positions) with prompts of 17, 64, 100 and 128 tokens, runs 5 warm
decode steps (the first runs eagerly, the second captures the step as
one CUDA graph), then 10 more, each one graph replay, timed without the
profiler, then 10 more under ``torch.profiler`` (CPU and CUDA
activities), and reports per decode step:

- wall ms: the host clock around the 10 unprofiled steps (admission
  checks, the step, argmax and its readback), ending in a synchronize;
  also under the profiler (``profiled_wall_ms_per_step``: its tracing
  slows each graph replay);
- event ms: CUDA events around each unprofiled step's decode call
  (staging copies, the replay and the logits' copy);
- device ms: the kernels' and copies' time from the profiler's
  ``key_averages()`` (one stream, so their sum is the busy time), or
  "not measured" where the profiler lists no kernel;
- the device's idle share, ``1 - device / wall``;
- launches: device events per step; the counted kernel launches a step
  (``CompiledStep.step_launches``), the captures and the capture's ms;
- the bound: every parameter byte, the live KV rows (MLA: the live
  latent rows, r + kr floats a position) and the conv and SSM states
  read once, the states written once, at 3.35 TB/s; for an MoE model
  only the experts that some slot chose in each layer (counted in the
  first, eager step) are read, ``bound_ms`` counts those and
  ``bound_all_experts_ms`` every expert;
- the kernels by device time, with their launches per step, and the
  longest single launches (the head's float32 copy and the unembedding
  among them).

whisper-base and internvl2-26b are served in lock step instead, as
``repro_torch.launch.serve`` serves them (the batcher's requests carry
no encoder frames): 4 prompts of 32 tokens with encoder frames
(whisper, 1,500) or a vision prefix (internvl2, 256 patches) drawn from
``--seed`` (normal, std 1), one batched prefill, then the decode steps
through one ``CompiledStep``, warmed, timed and profiled as above.  Their
bound adds the encoder output read once and, as an operation bound at
the bf16 tensor-core rate, whisper's cross-attention K and V projected
from it in every layer each step.

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

from chip_smoke import (BF16_OPS_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                        TimedSteps, card_line)

PROMPT_LENS = (17, 64, 100, 128)
# the configs served in lock step with seeded frontends; their prompt
FRONTEND_ARCHS = ("whisper_base", "internvl2_26b")
FRONTEND_PROMPT = 32
PREFILL_LENS = (17, 100, 255)     # chip_smoke.py's shortest, middle, longest
N_SLOTS, MAX_LEN = 4, 512
WARM, STEPS = 5, 10
OUT = ROOT / "chiprun_out" / "serve_profile.json"
# kernel family -> substrings of its kernels' names
FAMILIES = {"fused_mlp": ("mlp_",),
            "ssd_scan": ("ssd_kernel", "chunk_pass", "state_pass",
                         "output_pass"),
            "decode_attention": ("decode_kernel", "decode_split_kernel",
                                 "mla_extent_kernel", "mla_decode_kernel",
                                 "mla_combine_kernel")}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_2b",
                    help="granite_3_2b, mamba2_2p7b, zamba2_1p2b, "
                         "granite_moe_3b_a800m, minicpm3_4b, whisper_base "
                         "or internvl2_26b")
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

    smi, _ = card_line()
    cfg = get_config(args.arch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    rng = np.random.default_rng(args.seed)
    if args.prefill:
        return profile_prefills(torch, profile, ProfilerActivity, M, cfg,
                                params, rng, smi, args.arch)
    if args.arch in FRONTEND_ARCHS:
        summary, rows = profile_lockstep(torch, cfg, params, args.seed, smi)
    else:
        summary, rows = profile_decode(torch, cfg, params, rng, smi)
    print(json.dumps(summary), flush=True)
    out = (OUT if args.arch == "granite_3_2b"
           else OUT.with_name(f"serve_profile_{args.arch}.json"))
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({**summary, "kernels": rows}, indent=1))
    return 0


def profile_decode(torch, cfg, params, rng, smi, steps: int = STEPS
                   ) -> tuple[dict, list]:
    """Fills the batcher's slots, warms up, times ``steps`` unprofiled
    steps and profiles ``steps`` more; returns (summary, kernel rows)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers as L
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    class Batcher(TimedSteps, ContinuousBatcher):
        """Records CUDA events around each decode call."""

    batcher = Batcher(cfg, params, N_SLOTS, MAX_LEN, device="cuda")
    for i, n in enumerate(PROMPT_LENS):
        batcher.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=WARM + 2 * steps + 2))

    def run_steps() -> float:
        """Host ms a step over ``steps`` steps, ending in a
        synchronize."""
        t0 = time.perf_counter()
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    with L.expert_choices() as routing:
        batcher.step()           # admits, then the eager first step
    # each MoE layer's experts in that decode step, after the prefills'
    # (the leading dense layers route nothing)
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    chosen = routing.chosen[-moe_layers:] if routing.chosen else []
    for _ in range(WARM - 1):
        batcher.step()
    torch.cuda.synchronize()
    batcher.decode_events.clear()
    wall_ms = run_steps()
    event_ms = sorted(a.elapsed_time(b) for a, b in batcher.decode_events)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run_steps()
    rows = device_rows(torch, prof, steps)
    summary = {"profile": cfg.name, "slots": N_SLOTS, "max_len": MAX_LEN,
               **step_summary(torch, prof, rows, batcher.compiled, wall_ms,
                              profiled_wall_ms, event_ms, smi, steps),
               "bound_ms": step_bound_ms(torch, params, batcher, chosen)}
    if chosen:
        summary["bound_all_experts_ms"] = step_bound_ms(torch, params,
                                                        batcher)
        summary["experts_read_per_layer"] = [
            int(t.unique().numel()) for t in chosen]
    return summary, rows


def frontend_inputs(torch, cfg, batch: int, seed: int) -> dict:
    """The frontend of ``cfg``'s family, ``batch`` rows of
    ``n_frontend_tokens`` drawn from ``seed`` (normal, std 1) in the
    config's type: {"enc_embeds": ...} (encdec), {"extra_embeds": ...}
    (vlm) or {}."""
    from repro_torch.models import model as M
    name = {"encdec": "enc_embeds", "vlm": "extra_embeds"}.get(cfg.family)
    if name is None:
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, cfg.n_frontend_tokens, cfg.d_model,
                    generator=gen, device="cuda")
    return {name: x.to(M.torch_dtype(cfg.dtype))}


def profile_lockstep(torch, cfg, params, seed, smi, steps: int = STEPS
                     ) -> tuple[dict, list]:
    """Lock-step serving of N_SLOTS prompts of FRONTEND_PROMPT tokens with
    seeded frontends (``launch.serve``'s path): prefill, WARM warm steps
    through one ``CompiledStep``, ``steps`` timed unprofiled, ``steps``
    profiled;
    returns (summary, kernel rows) as :func:`profile_decode` does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import cache_len
    from repro_torch.models import model as M
    from repro_torch.runtime.compiled_step import CompiledStep

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (N_SLOTS, FRONTEND_PROMPT),
                           generator=gen, device="cuda")
    inputs = frontend_inputs(torch, cfg, N_SLOTS, seed + 2)
    n_steps = WARM + 2 * steps
    max_len = cache_len(cfg, FRONTEND_PROMPT, n_steps + 1)
    cache = M.init_cache(cfg, N_SLOTS, max_len,
                         dtype=M.torch_dtype(cfg.dtype), device="cuda")
    logits, cache = M.prefill(params, cfg, prompt, cache, **inputs)

    def decode_fn(tok, index):
        out, new = M.decode_step(params, cfg, tok, {**cache, "index": index})
        return out, new["index"]

    step = CompiledStep(decode_fn, device="cuda")
    state = {"tok": logits.argmax(-1), "index": cache["index"]}
    events = []

    def one_step():
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out, state["index"] = step(state["tok"], state["index"])
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        events.append((ev0, ev1))
        state["tok"] = out.argmax(-1)

    def run_steps() -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    index0 = int(cache["index"])
    for _ in range(WARM):
        one_step()
    torch.cuda.synchronize()
    events.clear()
    wall_ms = run_steps()
    event_ms = sorted(a.elapsed_time(b) for a, b in events)
    # the bound at the middle of the timed window's lengths
    live = N_SLOTS * (index0 + WARM + steps // 2 + 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run_steps()
    rows = device_rows(torch, prof, steps)
    summary = {"profile": cfg.name, "slots": N_SLOTS,
               "prompt_len": FRONTEND_PROMPT,
               "frontend_tokens": cfg.n_frontend_tokens,
               "max_len": max_len,
               **step_summary(torch, prof, rows, step, wall_ms,
                              profiled_wall_ms, event_ms, smi, steps),
               **lockstep_bound(torch, cfg, params, cache, live)}
    return summary, rows


def step_summary(torch, prof, rows, step, wall_ms, profiled_wall_ms,
                 event_ms, smi, steps: int = STEPS) -> dict:
    """A profiled window's per-step numbers: wall, device and event ms,
    the idle share, launches (the profiler's and the counted ones of
    ``step``, a ``CompiledStep``), the kernel families and the top and
    longest kernels."""
    device_ms = sum(r["ms_per_step"] for r in rows)
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "event_ms_per_step": event_ms,
        "device_ms_per_step": device_ms if rows else "not measured",
        "idle_share": 1 - device_ms / wall_ms if rows else "not measured",
        "launches_per_step": sum(r["launches_per_step"] for r in rows),
        "counted_launches_per_step": step.step_launches,
        "captures": step.captures, "capture_ms": step.capture_ms,
        "families": families(rows), "top": rows[:8],
        "longest": longest_launches(torch, prof, 6), "card": smi}


def kv_row_bytes(cache) -> int:
    """The bytes of one slot's position in every per-layer attention
    leaf of ``cache`` (those whose declared axes, ``M.CACHE_AXES``, hold
    ``layers`` and ``seq``): K and V, or MLA's latent row."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves({k: v for k, v in cache.items() if k != "index"})
    n = 0
    for t, axes in zip(leaves, tree_leaves(M.cache_axes(cache))):
        if "layers" in axes and "seq" in axes:
            n += t.numel() // (t.shape[axes.index("batch")]
                               * t.shape[axes.index("seq")]) * t.element_size()
    return n


def lockstep_bound(torch, cfg, params, cache, live: int) -> dict:
    """The least time of one lock-step decode step: every parameter, the
    ``live`` KV rows and the encoder output read once at the card's
    memory rate, against whisper's cross-attention K and V projected
    from the encoder output in every decoder layer at the bf16
    tensor-core rate; the larger bounds it."""
    def nbytes(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        return sum(nbytes(v) for v in tree.values())
    n = nbytes(params) + kv_row_bytes(cache) * live
    ops = 0
    if "enc_out" in cache:               # (slots, frames, d)
        enc = cache["enc_out"]
        n += enc.numel() * enc.element_size()
        ops = cfg.n_layers * 2 * 2 * enc.numel() * cfg.n_kv_heads * cfg.hd
    bytes_ms = n / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_bytes_ms": bytes_ms,
            "bound_ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def step_bound_ms(torch, params, batcher, chosen=()) -> float:
    """The least time of one decode step at the batcher's lengths: the
    parameters, each slot's live KV rows and the conv and SSM states
    read once, the states written once, at the card's memory rate.
    ``chosen``: each MoE layer's chosen experts (B, 1, K); only those
    experts' weights count then."""
    def nbytes(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        return sum(nbytes(v) for v in tree.values())
    cache = batcher.cache
    n = nbytes(params) + 2 * sum(nbytes(cache[k]) for k in ("conv", "ssm")
                                 if k in cache)
    if chosen:                           # (layers, E, ...) expert weights
        mlp = params["blocks"]["mlp"]
        per_expert = sum(nbytes(mlp[k]) for k in ("wg", "wu", "wd")) / (
            mlp["wg"].shape[0] * mlp["wg"].shape[1])
        unread = sum(mlp["wg"].shape[1] - t.unique().numel()
                     for t in chosen)
        n -= unread * per_expert
    live = int(batcher.lengths.sum() + N_SLOTS)
    return (n + kv_row_bytes(cache) * live) / HBM_BYTES_PER_S * 1e3


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


def longest_launches(torch, prof, n: int) -> list[dict]:
    """The longest single launch of each kernel, for the ``n`` kernels
    whose longest launch is longest."""
    longest: dict[str, float] = {}
    for e in prof.events():
        if _is_device_op(torch, e):
            longest[e.name] = max(longest.get(e.name, 0.0), _device_us(e))
    top = sorted(longest.items(), key=lambda kv: -kv[1])[:n]
    return [{"name": name[:120], "ms": us / 1e3} for name, us in top]


def _is_device_op(torch, evt) -> bool:
    """A kernel, copy or fill on the card: not the device-side mirror of
    a host range (the port's spans open one while the profiler records)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def device_rows(torch, prof, steps: int) -> list[dict]:
    """The profiled kernels and copies by device time, per step."""
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and _is_device_op(torch, evt):
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
