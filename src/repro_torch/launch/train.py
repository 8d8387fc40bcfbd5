"""Training launcher (the port of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch granite_3_2b [--full]
--steps 100 --global-batch 8 --seq 128 [--device cpu]``

Wires the train step, deterministic data (``SyntheticLM`` from
``--seed``), async checkpoints and the preemption and straggler handling
together, through :class:`~repro_torch.runtime.trainer.Trainer`, on the
card (default) or the CPU (``--device cpu``, the plain PyTorch
versions).  ``--smoke`` (the default) takes the config's reduced
same-family size; ``--full`` its published one, refused with
``ValueError`` when the busiest card's bytes (:func:`train_bytes_per_card`)
exceed one card (``launch.serve.ONE_CARD_BYTES``).  ``--mesh-data D
--mesh-model M`` trains on a D x M mesh (``launch.mesh.launch_mesh``:
one card a position where there are enough, else one card may hold
several positions or the whole mesh): the state split by
``train_state_shardings``, the sharded train step.  The
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
from repro_torch.launch.mesh import bytes_per_device, launch_mesh
from repro_torch.launch.serve import ONE_CARD_BYTES
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import TRAIN_RULES
from repro_torch.runtime.steps import (abstract_train_state, data_shards,
                                       train_state_shardings)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["main", "train_state_bytes", "train_bytes_per_card"]


def train_state_bytes(cfg) -> int:
    """Bytes of the training state: weights and gradients in the
    config's type, float32 master, m and v."""
    return cfg.n_params() * (2 * M.torch_dtype(cfg.dtype).itemsize + 12)


def train_bytes_per_card(cfg, mesh=None, global_batch: int = 8) -> int:
    """The training bytes the busiest card holds: without a mesh,
    :func:`train_state_bytes`; under one, the state pieces of its
    positions, the whole parameters the step gathers there and one
    gradient set for each data shard it runs."""
    if mesh is None:
        return train_state_bytes(cfg)
    full = cfg.n_params() * M.torch_dtype(cfg.dtype).itemsize
    per = bytes_per_device(mesh, train_state_shardings(cfg, mesh),
                           abstract_train_state(cfg))
    runs: dict = {}
    for _, dev, _ in data_shards(mesh, TRAIN_RULES, global_batch):
        runs[dev] = runs.get(dev, 0) + 1
    return max(v + (full * (1 + runs[d]) if d in runs else 0)
               for d, v in per.items())


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
                    help="data-axis size (0 = no mesh, one device)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = (launch_mesh(args.mesh_data, args.mesh_model, args.device)
            if args.mesh_data else None)
    need = train_bytes_per_card(cfg, mesh, args.global_batch)
    if need > ONE_CARD_BYTES:
        where = ("one card" if mesh is None else
                 f"the busiest card of the {args.mesh_data}x"
                 f"{args.mesh_model} mesh over {len(mesh.distinct_devices)} "
                 f"device(s)")
        raise ValueError(
            f"{cfg.name}: training takes {need / 1e9:.0f} GB on {where}, "
            f"past its {ONE_CARD_BYTES / 1e9:.0f} GB; it needs a mesh over "
            f"more cards")
    print(f"{cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{need / 1e9:.2f} GB on the busiest card"
          + ("" if mesh is None else f", mesh {mesh.shape} over "
             f"{', '.join(map(str, mesh.distinct_devices))}"))
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
    hist = Trainer(cfg, opt, tcfg, data, mesh=mesh).run()
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
