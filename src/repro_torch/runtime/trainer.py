"""The training orchestrator: data -> step -> metrics -> checkpoints,
with preemption and straggler handling (the port of
``repro.runtime.trainer``).

``Trainer`` owns no model logic: it wires the train step
(:func:`repro_torch.runtime.steps.make_train_step`), the data pipeline,
the async checkpointer and the fault machinery together.  Unlike the
reference there is no ``jax.jit``: the step runs eagerly, updating the
state in place; ``n_hosts`` is 1.  ``device`` (in
:class:`TrainerConfig`) picks the card (default) or the CPU.  With
``mesh=`` the state is sharded (``state_shardings``, by default
:func:`~repro_torch.runtime.steps.train_state_shardings` under
``TRAIN_RULES``), the step is the sharded one, and a restore splits the
checkpoint onto the mesh whatever mesh shape saved it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compression import ef_init
from repro_torch.runtime.fault import PreemptionGuard, StragglerMonitor
from repro_torch.runtime.steps import (abstract_train_state, make_train_step,
                                       shard_train_state,
                                       train_state_shardings)

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    log_every: int = 10
    compress_grads: bool = False
    seed: int = 0
    device: str | None = None          # None: the card


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, data, mesh=None,
                 state_shardings=None):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.data = data
        self.mesh = mesh
        self.device = (resolve_device(tcfg.device) if mesh is None
                       else mesh.devices.flat[0])
        if mesh is not None and state_shardings is None:
            state_shardings = train_state_shardings(
                cfg, mesh, compress_grads=tcfg.compress_grads)
        self.state_shardings = state_shardings
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.monitor = StragglerMonitor(n_hosts=1)
        self.step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                                       compress_grads=tcfg.compress_grads)
        self.state = self._init_or_restore()
        self.history: list[dict] = []

    # -- state ----------------------------------------------------------
    def _fresh_state(self) -> dict:
        params = M.init(self.cfg, self.tcfg.seed, device=self.device)
        if self.mesh is not None:
            return shard_train_state(params, self.state_shardings,
                                     self.tcfg.compress_grads)
        state = {"params": params, "opt": adamw_init(params)}
        if self.tcfg.compress_grads:
            state["ef"] = ef_init(params)
        return state

    def _init_or_restore(self) -> dict:
        latest = self.ckpt.latest_step()
        if latest is None:
            return self._fresh_state()
        like = abstract_train_state(self.cfg, self.tcfg.compress_grads)
        if self.mesh is not None:
            return self.ckpt.restore(like, step=latest,
                                     shardings=self.state_shardings)
        return self.ckpt.restore(like, step=latest, device=self.device)

    @property
    def step(self) -> int:
        return int(self.state["opt"]["step"])

    # -- loop -----------------------------------------------------------
    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.tcfg.total_steps
        with PreemptionGuard() as guard:
            while self.step < steps:
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                         for k, v in self.data.batch(self.step).items()}
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                metrics["step_time_s"] = dt
                metrics["step"] = self.step
                self.history.append(metrics)
                flagged = self.monitor.observe(np.array([dt]))
                if flagged:
                    metrics["stragglers"] = flagged
                if self.step % self.tcfg.log_every == 0:
                    print(f"step {self.step:6d} "
                          f"loss {metrics['loss']:8.4f} "
                          f"|g| {metrics['grad_norm']:8.3f} "
                          f"lr {metrics['lr']:.2e} "
                          f"{dt*1e3:8.1f} ms")
                if self.step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(self.state, self.step)
                if guard.preempted:
                    print("preemption notice: synchronous final save")
                    self.ckpt.save(self.state, self.step, blocking=True)
                    break
        self.ckpt.wait()
        return self.history
