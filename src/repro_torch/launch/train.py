"""Training launcher (the port of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch granite_3_2b [--full]
--steps 100 --global-batch 8 --seq 128 [--device cpu]``

Wires the train step, deterministic data (``SyntheticLM`` from
``--seed``), async checkpoints and the preemption and straggler handling
together, through :class:`~repro_torch.runtime.trainer.Trainer`, on the
card (default) or the CPU (``--device cpu``, the plain PyTorch
versions).  ``--smoke`` (the default) takes the config's reduced
same-family size; ``--full`` its published one, refused with
``NotPortedError`` when its training state (weights and gradients in
the config's type, float32 master, m and v: 16 bytes a parameter in
bf16) exceeds one card (``launch.serve.ONE_CARD_BYTES``): such a config
needs sharded training (ROADMAP A9), as does ``--mesh-data``.  The
encoder's frames (``encdec``) and the vision prefix (``vlm``) are zeros
of ``n_frontend_tokens`` positions, as ``launch/serve.py`` gives them
(the reference's launcher passes none, and its ``loss_fn`` then fails
for whisper).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import NotPortedError
from repro_torch.launch.serve import ONE_CARD_BYTES
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["main", "train_state_bytes"]


def train_state_bytes(cfg) -> int:
    """Bytes of the training state: weights and gradients in the
    config's type, float32 master, m and v."""
    return cfg.n_params() * (2 * M.torch_dtype(cfg.dtype).itemsize + 12)


class _WithFrontend:
    """The batches of ``data`` with the zero frontend a ``vlm`` or
    ``encdec`` config takes (``extra_embeds`` / ``enc_embeds``)."""

    def __init__(self, data, cfg):
        self.data, self.cfg = data, cfg

    def batch(self, step: int) -> dict:
        out = dict(self.data.batch(step))
        cfg = self.cfg
        zeros = np.zeros((out["tokens"].shape[0], cfg.n_frontend_tokens,
                          cfg.d_model), np.float32)
        out["extra_embeds" if cfg.family == "vlm" else "enc_embeds"] = zeros
        return out


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_3_2b",
                    help=f"one of {ARCHS}")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced same-family config")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="sharded training: not ported, raises")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh_data:
        raise NotPortedError("--mesh-data (sharded training, ROADMAP A9) is "
                             "not ported yet")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    need = train_state_bytes(cfg)
    if need > ONE_CARD_BYTES:
        raise NotPortedError(
            f"{cfg.name}: its training state takes {need / 1e9:.0f} GB, past "
            f"one card's {ONE_CARD_BYTES / 1e9:.0f} GB; training it needs "
            f"sharded training (ROADMAP A9), which is not ported yet")
    print(f"{cfg.name}: {cfg.n_params() / 1e6:.1f}M params, training state "
          f"{need / 1e9:.2f} GB")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.global_batch, seed=args.seed)
    if cfg.family in ("vlm", "encdec"):
        data = _WithFrontend(data, cfg)
    opt = AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
                      decay_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=10,
                         compress_grads=args.compress_grads, seed=args.seed,
                         device=args.device)
    hist = Trainer(cfg, opt, tcfg, data).run()
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
