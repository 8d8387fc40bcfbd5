"""Batched serving through the PyTorch/CUDA port: prefill +
decode with a KV cache (the twin of ``examples/serve_lm.py``).

A batch of prompts -> prefill (cache fill) -> token-by-token greedy
decode, with per-phase timing and the cache's size, for every assigned
config at its smoke size: granite-3-2b (dense), granite-moe-3b-a800m and
qwen3-moe-235b-a22b (moe), minicpm3-4b (dense with MLA, its latent
cache), mamba2-2.7b (ssm), zamba2-1.2b (hybrid), whisper-base (encdec:
the encoder's frames) and internvl2-26b (vlm: a vision prefix).  As in
the reference's example, the frames and the prefix are zeros; the cache
also holds the prefix (``repro_torch.launch.serve.cache_len``).  As the
reference jits its decode step, the decode step here is one CUDA graph
on the card (``CompiledStep``); with ``--device cpu`` it runs eagerly on
the plain PyTorch versions.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2_2p7b
      [--device cpu]    (or --arch granite_moe_3b_a800m, minicpm3_4b, ...)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCHS, get_smoke  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import cache_len  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime.compiled_step import CompiledStep  # noqa: E402


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b", help=f"one of {ARCHS}")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    dev = resolve_device(args.device)
    params = M.init(cfg, 0, device=dev)
    max_len = cache_len(cfg, args.prompt_len, args.gen_len)
    B = args.batch
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=gen, device=dev)
    kw = {}
    frontend = torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model),
                           device=dev)
    if cfg.family == "encdec":
        kw["enc_embeds"] = frontend
    if cfg.family == "vlm":
        kw["extra_embeds"] = frontend

    cache = M.init_cache(cfg, B, max_len, dtype=torch.float32, device=dev)
    cache_bytes = sum(x.numel() * x.element_size() for x in _leaves(cache))
    print(f"{cfg.name}: cache {cache_bytes / 1e6:.2f} MB for B={B} "
          f"max_len={max_len}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, prompt, cache, **kw)
    sync()
    t_prefill = time.perf_counter() - t0

    def decode_fn(tok, index):          # the cache is updated in place
        out, new = M.decode_step(params, cfg, tok, {**cache, "index": index})
        return out, new["index"]

    decode = CompiledStep(decode_fn, device=dev)
    tok, index = torch.argmax(logits, -1), cache["index"]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen_len - 1):
        logits, index = decode(tok, index)
        tok = torch.argmax(logits, -1)
        out_tokens.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.stack(out_tokens, 1).cpu().numpy()
    how = ("one CUDA graph" if decode.captures else "eager")
    print(f"prefill: {t_prefill * 1e3:8.1f} ms "
          f"({B * args.prompt_len / t_prefill:8.0f} tok/s)")
    print(f"decode:  {t_decode * 1e3:8.1f} ms "
          f"({B * (args.gen_len - 1) / t_decode:8.0f} tok/s), {how}")
    print(f"generated (first row): {gen_tokens[0][:16]}...")
    if not (np.all(gen_tokens >= 0) and np.all(gen_tokens < cfg.vocab_size)):
        raise RuntimeError("generated tokens outside the vocabulary")
    print("OK")
    return {"tokens": gen_tokens, "decode_captured": decode.captures > 0}


if __name__ == "__main__":
    main()
