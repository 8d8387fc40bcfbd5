"""End-to-end training with the PyTorch port: data -> step ->
checkpoints (the twin of ``examples/train_lm.py``).

Presets:
  tiny   ~2M params, a few hundred steps on the CPU        (default)
  100m   ~100M params (slow on the CPU, meant for the card)
  <arch> any assigned architecture's SMOKE config by name

Run:  PYTHONPATH=src python examples/train_lm_torch.py --preset tiny
      --steps 200 [--device cpu]
The default device is the card.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

from repro_torch.configs import ARCHS, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-llama", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2048,
        dtype="float32", remat="none"),
    "100m": ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
        dtype="float32", remat="none"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny",
                    help=f"tiny | 100m | one of {ARCHS}")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = (PRESETS[args.preset] if args.preset in PRESETS
           else get_smoke(args.preset))
    print(f"model {cfg.name}: {cfg.n_params()/1e6:.1f}M params")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    opt = AdamWConfig(lr_peak=args.lr, warmup_steps=20,
                      decay_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=100,
                       ckpt_dir=args.ckpt_dir, log_every=20,
                       device=args.device)
    tr = Trainer(cfg, opt, tc, data)
    hist = tr.run()
    print(f"\nloss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
          f"{len(hist)} steps  "
          f"({sum(h['step_time_s'] for h in hist):.1f}s total)")
    assert hist[-1]["loss"] < hist[0]["loss"], "training did not learn"
    print("OK")


if __name__ == "__main__":
    main()
