"""Serving launcher: batched prefill + greedy decode (the port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch granite_3_2b [--full]
--batch 4 --prompt-len 32 --gen-len 32 [--device cpu]``; ``--arch``
takes every assigned config: the dense ``granite_3_2b``, the MoE
``granite_moe_3b_a800m``, the MLA ``minicpm3_4b``, the SSM
``mamba2_2p7b``, the hybrid ``zamba2_1p2b``, the encoder-decoder
``whisper_base``, the vision-prefix ``internvl2_26b`` and, at its smoke
size only (``--smoke``, the default), ``qwen3_moe_235b_a22b``: a config
whose bytes on one card (:func:`serve_bytes_per_card`) exceed
:data:`ONE_CARD_BYTES` raises ``ValueError``.

Builds random parameters from ``--seed`` and a cache in the config's
type, prefills ``--batch`` random prompts at once and decodes
``--gen-len - 1`` more tokens in lock step.  ``--mesh-data D
--mesh-model M`` serves on a D x M mesh (``launch.mesh.launch_mesh``:
one card a position where there are enough, else one card may hold
several positions or the whole mesh): parameters split by
``SERVE_RULES``, the cache by ``cache_shardings``, the sharded prefill
and decode steps (``runtime/steps.py``).  As in the reference, the
encoder's frames (``encdec``) and the vision prefix (``vlm``) are zeros
of ``n_frontend_tokens`` positions.  The cache holds
:func:`cache_len` positions: the reference's ``prompt + gen + 8``, plus
the vision prefix for a ``vlm``, which the reference leaves out (its
prefill of internvl2 at ``--full``, 256 + 32 positions, then overflows
its 72-position cache).  The reference jits the
decode step with the cache donated; here a
:class:`~repro_torch.runtime.compiled_step.CompiledStep` captures it as
one CUDA graph on the card (the lock-step index is one of its input
buffers, refreshed from the step's ``index + 1``).  Prefill stays eager:
it runs once per shape.  On the card, prefill and decode are timed with
CUDA events; on the CPU (``--device cpu``, the plain PyTorch versions,
the step eager) with the host clock, and the output says which and
whether the decode ran captured.  A mesh whose positions share one card
is captured as one graph too; a mesh over several cards decodes eagerly
(a graph captures one device's stream) and says so.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import bytes_per_device, launch_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ShapeConfig
from repro_torch.parallel.sharding import (SERVE_RULES, make_param_shardings,
                                           shard_tree)
from repro_torch.runtime.compiled_step import CompiledStep
from repro_torch.runtime.steps import (abstract_train_state, cache_shardings,
                                       make_decode_step, make_prefill_step)

__all__ = ["main", "cache_len", "param_shardings", "serve_bytes_per_card",
           "ONE_CARD_BYTES"]

#: the bytes one card holds (an H100's 80 GB)
ONE_CARD_BYTES = 80e9


def param_shardings(cfg, mesh, rules=SERVE_RULES):
    """The parameters' shardings on ``mesh`` under ``rules``."""
    return make_param_shardings(mesh, M.param_axes(cfg), rules,
                                M.param_defs(cfg))


def serve_bytes_per_card(cfg, mesh=None) -> int:
    """The parameter bytes the busiest card holds: all of them without a
    mesh; under one, the pieces of its positions (``SERVE_RULES``) plus
    the whole copy the sharded step gathers there."""
    full = cfg.n_params() * M.torch_dtype(cfg.dtype).itemsize
    if mesh is None:
        return full
    like = abstract_train_state(cfg)["params"]
    per = bytes_per_device(mesh, param_shardings(cfg, mesh), like)
    return max(v + full for v in per.values())


def cache_len(cfg, prompt_len: int, gen_len: int) -> int:
    """The cache positions a served batch needs: the prompt, the
    generated tokens and 8 spare, as the reference sizes it, and for a
    ``vlm`` the vision prefix too (a deliberate difference: the reference
    omits it)."""
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    return prefix + prompt_len + gen_len + 8


class _Clock:
    """Elapsed milliseconds of a phase: CUDA events on the card, the
    host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.source = "cuda events" if dev.type == "cuda" else "host clock"

    def start(self):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop_ms(self, start) -> float:
        if self.dev.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return (time.perf_counter() - start) * 1e3


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_2b",
                    help=f"one of {ARCHS}")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data-axis size (0 = no mesh, one device)")
    ap.add_argument("--mesh-model", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dtype = M.torch_dtype(cfg.dtype)
    mesh = (launch_mesh(args.mesh_data, args.mesh_model, args.device)
            if args.mesh_data else None)
    need = serve_bytes_per_card(cfg, mesh)
    if need > ONE_CARD_BYTES:
        where = ("one card" if mesh is None else
                 f"the busiest card of the {args.mesh_data}x"
                 f"{args.mesh_model} mesh over {len(mesh.distinct_devices)} "
                 f"device(s)")
        raise ValueError(f"{cfg.name}: {need / 1e9:.0f} GB of parameters on "
                         f"{where} exceed its {ONE_CARD_BYTES / 1e9:.0f} GB; "
                         f"serving it needs model parallelism over more "
                         f"cards")
    dev = (resolve_device(args.device) if mesh is None
           else mesh.devices.flat[0])
    params = M.init(cfg, args.seed, device=dev)
    B = args.batch
    L = cache_len(cfg, args.prompt_len, args.gen_len)
    cache = M.init_cache(cfg, B, L, dtype=dtype, device=dev)
    if mesh is not None:
        params = shard_tree(params, param_shardings(cfg, mesh))
        cache = shard_tree(cache, cache_shardings(
            cfg, ShapeConfig("serve", L, B, "decode"), mesh))
        print(f"mesh {mesh.shape} over "
              f"{', '.join(map(str, mesh.distinct_devices))}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=gen, device=dev)
    batch = {"tokens": prompt}
    frontend = torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model),
                           dtype=dtype, device=dev)
    if cfg.family == "encdec":
        batch["enc_embeds"] = frontend
    if cfg.family == "vlm":
        batch["extra_embeds"] = frontend
    prefill = make_prefill_step(cfg, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)

    clock = _Clock(dev)
    t0 = clock.start()
    logits, cache = prefill(params, batch, cache)
    tp = clock.stop_ms(t0)

    def decode_fn(token, index):      # the cache is updated in place
        out, new = decode(params, {"token": token}, {**cache, "index": index})
        return out, new["index"]

    # a graph captures one device's stream: a mesh over several cards
    # decodes eagerly
    graphable = mesh is None or mesh.single_device
    step = CompiledStep(decode_fn, device=dev) if graphable else decode_fn
    tok, index = torch.argmax(logits, -1), cache["index"]
    outs = [tok]
    t0 = clock.start()
    for _ in range(args.gen_len - 1):
        logits, index = step(tok, index)
        tok = torch.argmax(logits, -1)
        outs.append(tok)
    td = clock.stop_ms(t0)
    captured = graphable and step.captures > 0

    gen_tokens = torch.stack(outs, 1).cpu().numpy()
    n_dec = B * (args.gen_len - 1)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name} on {where} ({clock.source}): prefill {tp:.1f} ms "
          f"({B * args.prompt_len / tp * 1e3:.0f} tok/s), decode "
          f"{td:.1f} ms ({n_dec / max(td, 1e-9) * 1e3:.0f} tok/s), "
          + ("captured as one CUDA graph" if captured else
             "eager" if graphable else
             f"eager (the mesh spans {len(mesh.distinct_devices)} cards)"))
    if not (np.all(gen_tokens >= 0) and np.all(gen_tokens < cfg.vocab_size)):
        raise RuntimeError("generated tokens outside the vocabulary")
    print("first row:", gen_tokens[0][:12], "... OK")
    return {"config": cfg.name, "device": where, "clock": clock.source,
            "prefill_ms": tp, "decode_ms": td, "decode_captured": captured,
            "mesh": None if mesh is None else mesh.shape,
            "tokens": gen_tokens}


if __name__ == "__main__":
    main()
