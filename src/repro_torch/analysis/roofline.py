"""Three-term roofline of a whole step (the port of
:mod:`repro.analysis.roofline`, its fields and arithmetic):

    T_compute    = FLOPs      / (chips * peak_FLOPs)
    T_memory     = bytes      / (chips * HBM_bw)
    T_collective = coll_bytes / (chips * link_bw)

The reference takes FLOPs and bytes from XLA's ``cost_analysis()`` and
the collective bytes from HLO text.  The port's dry run
(:mod:`repro_torch.launch.dryrun`) counts them from one traced step
instead, the same way whatever implements it, and hands
:func:`analyze` the collective bytes as a dict of ``collective_bytes``'
keys.  MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), D = tokens
processed.  No pass/fail.

The constants are one NVIDIA H100 SXM5 80GB's at its 700 W power limit
(:data:`H100_HW`); the port carries no TPU constant.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = ["HW", "H100_HW", "RooflineReport", "model_flops", "analyze"]


@dataclasses.dataclass(frozen=True)
class HW:
    #: bf16 dense tensor-core FLOP/s, NVIDIA H100 SXM5 80GB at 700 W
    #: (NVIDIA H100 data sheet)
    peak_flops: float = 989e12
    #: HBM3 bytes/s, the same card and source
    hbm_bw: float = 3.35e12
    #: bytes/s of one NVLink 4 link: 900 GB/s over the card's 18 links
    #: (the same data sheet)
    link_bw: float = 900e9 / 18


H100_HW = HW()


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float
    bytes_per_chip: dict
    note: str = ""

    def row(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:9s} "
                f"Tc={self.t_compute*1e3:9.3f}ms "
                f"Tm={self.t_memory*1e3:9.3f}ms "
                f"Tx={self.t_collective*1e3:9.3f}ms "
                f"dom={self.dominant:10s} "
                f"useful={self.useful_ratio:6.3f}")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D with N = active params, D = tokens touched this step."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    return 2.0 * n * shape.global_batch  # decode: 1 token / sequence


def analyze(arch: str, shape_cfg: ShapeConfig, mesh_name: str, chips: int,
            cost: dict, coll: dict, mem: dict, cfg: ModelConfig,
            hw: HW = H100_HW, note: str = "") -> RooflineReport:
    """The report of one cell: ``cost`` has ``"flops"`` and ``"bytes
    accessed"`` of the whole step, ``coll`` the collective bytes of the
    whole step by kind with ``"total"`` and ``"ops"`` (the keys of
    :func:`~repro_torch.analysis.hlo.collective_bytes`), ``mem`` the
    bytes a chip holds."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_c = flops / (chips * hw.peak_flops)
    t_m = byts / (chips * hw.hbm_bw)
    t_x = coll["total"] / (chips * hw.link_bw)
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape_cfg)
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll["total"],
        coll_breakdown={k: v for k, v in coll.items()
                        if k not in ("total", "ops")},
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dom,
        model_flops=mf, useful_ratio=(mf / flops if flops else 0.0),
        bytes_per_chip=mem, note=note)
