"""Tile selection for the Hopper group kernel (FLOWER contribution C3b).

Port of :mod:`repro.core.vectorize`.  The TPU version fits a
double-buffered working set into VMEM with 128-lane / 8-sublane tiles;
here one thread block computes one ``(th, tw)`` output tile and holds
a ``(th + 2hy, tw + 2hx)`` halo window of every buffered channel in
shared memory (:meth:`~repro_torch.core.schedule.FusionGroup.smem_bytes`),
so the budget is the 227 KB a block may use on an H100, and ``tw`` is
a multiple of the 32-thread warp (``tw == 32 * vector_factor``).

Two entry points, as in the reference:

- :func:`choose_tile` — the explicit knob: the caller fixes the vector
  factor, we fit the tallest tile whose windows hold the shared-memory
  budget, or raise when the factor cannot fit.
- :func:`select_tile` — the automatic mode: sweep tile heights and
  widths through :func:`modeled_plane_time` and keep the fastest.
  Tiles may differ from the TPU's; outputs may not.

The model's occupancy constants are not fitted, so its picks are held
against a tile sweep on the card (``tools/tile_sweep.py``): on an H100
SXM at 1080x1920 they ran 1.7-2.5x faster than the largest tile that
fits shared memory, and within 25 % of the best tile of the grid.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.graph import as_dtype
from repro_torch.core.schedule import FusionGroup

__all__ = ["GPUSpec", "H100", "choose_tile", "select_tile", "sweep_tiles",
           "modeled_plane_time", "DEFAULT_MAX_TILE",
           "LANE", "ROW_ALIGN", "THREADS_PER_BLOCK"]

LANE = 32            # warp width: tile widths are multiples of it
ROW_ALIGN = 8        # tile heights are multiples of it
THREADS_PER_BLOCK = 256   # sg::kThreads in csrc/stream_group.cuh

#: default (th, tw) cap for choose_tile/select_tile
DEFAULT_MAX_TILE = (64, 256)


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Per-card constants (NVIDIA H100 SXM by default, from its data
    sheet); :meth:`from_device` reads what the CUDA runtime reports."""

    sms: int = 132
    #: shared memory one block may opt into (227 KB)
    smem_per_block: int = 232448
    #: shared memory of one SM (228 KB), shared by its resident blocks
    smem_per_sm: int = 233472
    l2_bytes: int = 50 * 2**20
    hbm_bw: float = 3.35e12
    #: float32 rate outside the tensor cores
    fp32_flops: float = 67e12
    max_warps_per_sm: int = 64
    #: resident warps per SM the model assumes saturate device memory
    saturating_warps_per_sm: int = 32
    #: fixed cost of one wave of blocks (launch, fill, drain)
    wave_overhead_s: float = 1e-6

    @classmethod
    def from_device(cls, device=None) -> "GPUSpec":
        """The spec with SM count, shared memory and L2 read from the
        card (the bandwidth and rates stay the data sheet's)."""
        import torch
        props = torch.cuda.get_device_properties(device)
        per_block = getattr(props, "shared_memory_per_block_optin",
                            cls.smem_per_block)
        per_sm = getattr(props, "shared_memory_per_multiprocessor",
                         cls.smem_per_sm)
        return cls(sms=props.multi_processor_count,
                   smem_per_block=int(per_block), smem_per_sm=int(per_sm),
                   l2_bytes=int(getattr(props, "L2_cache_size",
                                        cls.l2_bytes)))


H100 = GPUSpec()


def _constants(spec, max_tile) -> tuple:
    return (spec or H100,
            tuple(max_tile) if max_tile is not None else DEFAULT_MAX_TILE)


def _plane(group: FusionGroup) -> tuple[int, int]:
    shape = group.stages[0].outputs[0].shape
    if len(shape) != 2:
        raise ValueError(f"generic fusion tiles 2-D planes, got {shape}")
    return shape


def _caps(group: FusionGroup, max_tile) -> tuple[int, int]:
    H, W = _plane(group)
    cap_th = min(_round_up(H, ROW_ALIGN),
                 max(ROW_ALIGN, (max_tile[0] // ROW_ALIGN) * ROW_ALIGN))
    cap_tw = min(_round_up(W, LANE), max(LANE, (max_tile[1] // LANE) * LANE))
    return cap_th, cap_tw


def choose_tile(group: FusionGroup, spec: GPUSpec | None = None,
                vector_factor: int = 1,
                max_tile: tuple[int, int] | None = None) -> tuple[int, int]:
    """Pick (th, tw) for a fusion group at a fixed vector factor.

    ``tw`` is exactly ``32 * vector_factor``.  ``th`` starts at the
    tallest 8-aligned height within ``max_tile[0]`` and the plane, then
    halves until the group's shared-memory windows fit one block.
    Raises :class:`ValueError` when the factor is wider than the plane
    or the cap, or when even an 8-row tile does not fit.
    """
    spec, max_tile = _constants(spec, max_tile)
    if vector_factor < 1:
        raise ValueError(f"vector_factor must be >= 1, got {vector_factor}")
    cap_th, cap_tw = _caps(group, max_tile)
    tw = LANE * vector_factor
    if tw > cap_tw:
        raise ValueError(
            f"vector_factor={vector_factor} needs a {tw}-wide tile, but the "
            f"widest feasible tile is {cap_tw} (plane {_plane(group)}, "
            f"max_tile[1]={max_tile[1]})")
    th = cap_th
    while group.smem_bytes((th, tw)) > spec.smem_per_block:
        if th > ROW_ALIGN:
            th = max(ROW_ALIGN, _round_up(th // 2, ROW_ALIGN))
        else:
            raise ValueError(
                f"group {[s.name for s in group.stages]} cannot fit the "
                f"shared-memory budget {spec.smem_per_block} even at tile "
                f"({ROW_ALIGN}, {tw}): {group.smem_bytes((th, tw))} bytes")
    group.tile = (th, tw)
    group.vector_factor = vector_factor
    return group.tile


def modeled_plane_time(group: FusionGroup, tile: tuple[int, int],
                       spec: GPUSpec = H100) -> float:
    """Modeled seconds for the group kernel over the whole plane.

    Each block reads every input's halo window and writes its output
    tiles (halo re-reads favour larger tiles); each stage evaluates its
    output's halo-extended region.  Memory and compute overlap, but
    only as far as enough warps are resident: blocks per SM are bounded
    by shared memory and warp slots, and a grid with too few blocks
    leaves part of the card's memory parallelism unused (which favours
    smaller tiles).  Each wave of blocks pays a fixed overhead.
    """
    th, tw = tile
    H, W = _plane(group)
    blocks = math.ceil(H / th) * math.ceil(W / tw)
    bytes_block = 0
    for ch in group.inputs:
        hy, hx = group.halo.get(ch, (0, 0))
        bytes_block += (th + 2 * hy) * (tw + 2 * hx) * _itemsize(ch)
    for ch in group.outputs:
        bytes_block += th * tw * _itemsize(ch)
    ops_block = 0.0
    for st in group.stages:
        hy, hx = _out_halo(group, st)
        ops_block += st.ii * (th + 2 * hy) * (tw + 2 * hx)
    warps = THREADS_PER_BLOCK // 32
    smem = max(1, group.smem_bytes(tile))
    per_sm = max(1, min(spec.smem_per_sm // smem,
                        spec.max_warps_per_sm // warps))
    resident = min(blocks, spec.sms * per_sm)
    fill = min(1.0, resident * warps
               / (spec.sms * spec.saturating_warps_per_sm))
    dma_s = blocks * bytes_block / (spec.hbm_bw * fill)
    compute_s = blocks * ops_block / (spec.fp32_flops * fill)
    waves = math.ceil(blocks / (spec.sms * per_sm))
    return max(dma_s, compute_s) + waves * spec.wave_overhead_s


def sweep_tiles(group: FusionGroup, spec: GPUSpec | None = None,
                max_tile: tuple[int, int] | None = None,
                trace=None) -> list[dict]:
    """Cost-model sweep over (th, tw); one record per candidate.

    Heights run over the 8-aligned powers of two up to the cap, widths
    over every multiple of 32 up to the cap.  Each record carries
    ``tile``, ``vector_factor``, ``feasible`` and ``modeled_s``; the
    group's own tile is left as it was (the sweep only scores).
    """
    spec, max_tile = _constants(spec, max_tile)
    if trace is not None:
        with trace.span("compile.vectorize.sweep", cat="compile",
                        group=",".join(s.name for s in group.stages)) as sp:
            records = sweep_tiles(group, spec, max_tile)
            sp.set(candidates=len(records),
                   feasible=sum(1 for r in records if r["feasible"]))
            return records
    cap_th, cap_tw = _caps(group, max_tile)
    heights = sorted({min(cap_th, ROW_ALIGN << k)
                      for k in range(max(1, cap_th.bit_length()))})
    records: list[dict] = []
    for vf in range(1, cap_tw // LANE + 1):
        for th in heights:
            tile = (th, LANE * vf)
            smem = group.smem_bytes(tile)
            ok = smem <= spec.smem_per_block
            records.append({
                "tile": tile, "vector_factor": vf, "feasible": ok,
                "smem_bytes": smem,
                "modeled_s": (modeled_plane_time(group, tile, spec)
                              if ok else float("inf"))})
    return records


def select_tile(group: FusionGroup, spec: GPUSpec | None = None,
                vector_factor: int | None = None,
                max_tile: tuple[int, int] | None = None,
                trace=None) -> tuple[tuple[int, int], list[dict] | None]:
    """Pick the group's tile; sweep when no vector factor is forced.

    Returns ``(tile, sweep_records)`` (``None`` records in forced mode)
    and sets the group's ``tile`` and ``vector_factor``.  Ties break
    toward the larger tile (fewer halo re-reads).
    """
    if vector_factor is not None:
        return choose_tile(group, spec, vector_factor, max_tile), None
    records = sweep_tiles(group, spec, max_tile, trace=trace)
    feasible = [r for r in records if r["feasible"]]
    if not feasible:
        raise ValueError(
            f"no tile of group {[s.name for s in group.stages]} fits the "
            f"shared-memory budget")
    best = min(feasible, key=lambda r: (r["modeled_s"],
                                        -r["tile"][0] * r["tile"][1]))
    group.tile = best["tile"]
    group.vector_factor = best["vector_factor"]
    return group.tile, records


def _out_halo(group: FusionGroup, st) -> tuple[int, int]:
    hs = [group.halo.get(ch, (0, 0)) for ch in st.outputs]
    return (max(h[0] for h in hs), max(h[1] for h in hs))


def _itemsize(ch) -> int:
    return as_dtype(ch.dtype).itemsize


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
