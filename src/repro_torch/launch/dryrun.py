"""Multi-pod dry run: trace every (arch x shape x mesh) cell on ``meta``
devices (the port of :mod:`repro.launch.dryrun`).

For each cell this builds the *real* step function (train / prefill /
decode, :mod:`repro_torch.runtime.steps` with ``mesh=`` and ``rules=``)
over the production mesh with ``meta`` at every position, runs it once
on ``meta`` stand-ins (``abstract_train_state``, ``batch_specs``,
``abstract_cache``: nothing is allocated) and records:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  whole step, forward and backward (its products: matmuls,
  convolutions, attention; XLA's ``cost_analysis`` also counts
  elementwise work);
- bytes accessed: every aten op's operand and result bytes (views
  excluded), an unfused count and so an upper bound on the device-memory
  traffic (XLA counts after fusion, so the two differ by design);
- collective bytes: what the port's own collectives move between mesh
  positions (:mod:`repro_torch.parallel.traffic`), under the reference's
  kinds;
- bytes a device: the arguments from the sharding plan (the busiest
  position's share, :func:`~repro_torch.parallel.sharding.resident_bytes`,
  which ``launch.mesh.bytes_per_device`` sums a device), the
  temporaries from the peak of live ``meta`` bytes during the step;
- the three roofline terms over an H100's peaks
  (:mod:`repro_torch.analysis.roofline`) and the dominant one.

The kernels cannot launch on ``meta`` (``kernels/launch.py`` refuses it),
so a dry run takes the plain versions (``attn_impl="ref"``), as the
reference's dry run lowers its XLA path and not its Pallas kernels.  Each
row's ``note`` says so.  A traced step counts every op it runs, so no
loop is undercounted; :func:`calibrate` keeps the reference's L1 / L2
extrapolation as a cross-check of the full count.

Usage:
  python -m repro_torch.launch.dryrun --arch granite_3_2b --shape train_4k \\
      --mesh pod                      # one cell (subprocess-friendly)
  python -m repro_torch.launch.dryrun --sweep --mesh both --jobs 3
                                      # all cells via subprocesses
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import analyze
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.parallel import traffic
from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES, Mesh,
                                           make_param_shardings,
                                           resident_bytes, shard_tree)
from repro_torch.runtime import steps as S

__all__ = ["runtime_cfg", "arch_rules", "calib_layers", "skip_reason",
           "run_cell", "calibrate", "cell_path", "sweep", "main", "OUT_DIR"]

OUT_DIR = "experiments/dryrun_torch"
#: cells whose trace took over 15 minutes on the host of an NVIDIA H100
#: 80GB HBM3 (700.00 W; 8 cores, seven cells at once; PERF.md): a sweep
#: runs them only when ``--arch`` names their arch
SLOW_CELLS = {("qwen3_moe_235b_a22b", "train_4k")}
#: what every row's note says about how it was counted
NOTE = ("attn_impl='ref': the plain versions, the kernels cannot launch on "
        "meta (the reference's dry run lowers its XLA path too); flops: "
        "FlopCounterMode's products; bytes: every aten op's operands and "
        "results, unfused (an upper bound; XLA counts after fusion); "
        "collectives: the bytes the port's own collectives move between "
        "mesh positions; temp: the peak of live meta bytes, the data "
        "shards' share a device")


# ----------------------------------------------------------------------
# per-shape runtime knobs (NOT architecture: execution strategy)
# ----------------------------------------------------------------------
def runtime_cfg(cfg: ModelConfig, shape: ShapeConfig,
                overrides: dict | None = None) -> ModelConfig:
    kw: dict = {}
    if shape.seq_len > 2048 and cfg.family not in ("ssm",):
        kw["attn_chunk"] = 2048 if shape.seq_len >= 32768 else 1024
    if shape.kind == "train":
        kw["remat"] = "dots"
        kw["microbatches"] = 8
    kw.update(overrides or {})
    global EP_OVER_DATA
    EP_OVER_DATA = bool(kw.pop("ep_over_data", False))
    return dataclasses.replace(cfg, **kw)


EP_OVER_DATA = False   # set by --overrides {"ep_over_data": true}


def arch_rules(cfg: ModelConfig, mesh, rules):
    """Per-arch fallbacks and EP placement.

    - experts %% model axis != 0 (granite-moe 40/16): fall back to
      tensor parallelism *inside* each expert (d_ff sharded).
    - ep_over_data: shard experts over the *data* axis instead of
      FSDP'ing their weights.
    """
    msize = mesh.shape.get("model", 1)
    dsize = mesh.shape.get("data", 1)
    if cfg.n_experts and EP_OVER_DATA and cfg.n_experts % dsize == 0:
        return rules.replace(experts="data", expert_ff="model")
    if cfg.n_experts and cfg.n_experts % msize != 0:
        rules = rules.replace(experts=None, expert_ff="model")
    return rules


def calib_layers(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    return 1, 2


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("long_500k needs sub-quadratic context state; "
                f"{cfg.name} is pure full-attention (assignment rule: skip)")
    return None


# ----------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Cell:
    """One cell's step, its ``meta`` arguments (sharded), and, for the
    memory plan, each argument's shardings and shapes."""
    kind: str
    step: Callable
    args: tuple
    shardings: tuple
    likes: tuple
    #: the bytes of the whole parameters (one gathered copy)
    param_bytes: int
    #: the data shards the step runs
    n_shards: int
    #: bytes of what the step returns besides the state or cache (a
    #: serving step's float32 logits, whole on the first data shard)
    out_bytes: int = 0

    def run(self) -> Any:
        return self.step(*self.args)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                notes: list[str]) -> _Cell:
    """Build the real step function of one cell and its sharded ``meta``
    arguments."""
    if shape.kind == "train":
        rules = arch_rules(cfg, mesh, TRAIN_RULES)
        state_av = S.abstract_train_state(cfg)
        state_sh = S.train_state_shardings(cfg, mesh, rules=rules,
                                           notes=notes)
        batch_av = S.batch_specs(cfg, shape)
        batch_sh = S.batch_shardings(cfg, shape, mesh, rules)
        step = S.make_train_step(cfg, AdamWConfig(), mesh=mesh, rules=rules)
        params_av = state_av["params"]
        B = shape.global_batch // max(cfg.microbatches, 1)
        return _Cell("train", step, (shard_tree(state_av, state_sh),
                                     batch_av),
                     (state_sh, batch_sh), (state_av, batch_av),
                     sum(_nbytes(t) for t in tree_leaves(params_av)),
                     len(S.data_shards(mesh, rules, B)))
    rules = arch_rules(cfg, mesh, SERVE_RULES)
    params_av = S.abstract_train_state(cfg)["params"]
    params_sh = make_param_shardings(mesh, M.param_axes(cfg), rules,
                                     M.param_defs(cfg), notes)
    cache_av = S.abstract_cache(cfg, shape)
    cache_sh = S.cache_shardings(cfg, shape, mesh, rules)
    batch_av = S.batch_specs(cfg, shape)
    batch_sh = S.batch_shardings(cfg, shape, mesh, rules)
    make = (S.make_prefill_step if shape.kind == "prefill"
            else S.make_decode_step)
    step = make(cfg, mesh=mesh, rules=rules)
    return _Cell(shape.kind, step,
                 (shard_tree(params_av, params_sh), batch_av,
                  shard_tree(cache_av, cache_sh)),
                 (params_sh, batch_sh, cache_sh),
                 (params_av, batch_av, cache_av),
                 sum(_nbytes(t) for t in tree_leaves(params_av)),
                 len(S.data_shards(mesh, rules, shape.global_batch)),
                 4 * shape.global_batch * cfg.vocab_size)


#: ops that allocate but move no data
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided"}


def _tensors(x) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results (lists of them
    too)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(map(_arg_key, a))
    if isinstance(a, (bool, int, float, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format)):
        return (type(a), a)
    raise TypeError(type(a))


def _functional(func) -> bool:
    """Whether ``func`` returns one new tensor and writes no argument: its
    result's shape, strides and type follow from its arguments'."""
    schema = func._schema
    return (len(schema.returns) == 1
            and str(schema.returns[0].type) == "Tensor"
            and schema.returns[0].alias_info is None
            and not any(a.alias_info is not None for a in schema.arguments))


class _Counter(TorchDispatchMode):
    """One mode that counts every aten op of a step: its products' FLOPs
    (``FlopCounterMode``'s registry and totals, called from here: its own
    mode would first try to decompose every op outside its registry,
    which re-runs elementwise ops in Python and adds no product), its
    operand and result bytes (views excluded), and the bytes of the
    storages ops create while they live, with their peak.

    Many ``meta`` kernels are Python (the elementwise ones among them),
    and a step repeats the same ops for every layer, data shard and
    microbatch.  So a functional op's result metadata (shape,
    strides, type) is kept by its arguments' metadata, and an op seen
    before gets a fresh ``meta`` tensor of that metadata without its
    kernel, as ``FakeTensorMode``'s dispatch cache does: every op is
    still dispatched and counted."""

    def __init__(self):
        super().__init__()
        self.flops = FlopCounterMode(display=False)
        self._registry = self.flops.flop_registry
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: set[int] = set()
        self._pure: dict = {}
        self._results: dict = {}

    def _release(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def _run(self, func, args, kwargs):
        pure = self._pure.get(func)
        if pure is None:
            pure = self._pure[func] = _functional(func)
        if not pure:
            return func(*args, **kwargs)
        try:
            key = (func, _arg_key(args), _arg_key(tuple(kwargs.items())))
        except TypeError:                     # an argument it cannot key
            return func(*args, **kwargs)
        meta = self._results.get(key)
        if meta is not None:
            return torch.empty_strided(meta[0], meta[1], dtype=meta[2],
                                       device="meta")
        out = func(*args, **kwargs)
        if not (isinstance(out, torch.Tensor) and out.device.type == "meta"):
            return out
        meta = self._results[key] = (out.shape, out.stride(), out.dtype)
        # a new tensor, as the schema and the card's kernel give: a
        # Python meta kernel may hand back an argument unchanged
        return torch.empty_strided(meta[0], meta[1], dtype=meta[2],
                                   device="meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if func.is_view:
            return out
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops._count_flops(packet, out, args, kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if func._opname not in _NO_DATA:
            self.bytes += (sum(t.nbytes for t in ins)
                           + sum(t.nbytes for t in outs))
        inputs = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in inputs or key in self._held:
                continue                       # in place, or seen
            n = s.nbytes()
            self._held.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._release, key, n)
        return out


def _cell_costs(cell: _Cell) -> dict:
    """One run of the cell's step, counted: FLOPs, bytes accessed,
    collective bytes (``total`` and by kind), the peak of live
    temporaries and the seconds it took."""
    counter = _Counter()
    t0 = time.perf_counter()
    with traffic.count_traffic() as coll, counter:
        cell.run()
    seconds = time.perf_counter() - t0
    return {"flops": float(counter.flops.get_total_flops()),
            "bytes": float(counter.bytes),
            "coll": coll["total"],
            "coll_breakdown": {k: v for k, v in coll.items()
                               if k not in ("total", "ops")},
            "coll_ops": coll["ops"],
            "temp_peak": int(counter.peak),
            "seconds": seconds}


def _memory(cell: _Cell, costs: dict) -> dict:
    """Bytes a device, the reference's keys: arguments from the sharding
    plan (the busiest position), outputs and aliases (the state or cache,
    updated in place; a serving step's logits whole), temporaries from
    the traced peak.  A ``meta`` mesh is one device, so the peak holds
    every data shard's temporaries; a device holds one data shard's (a
    train step's: all of them live at once, through one backward) and
    one gathered copy of the parameters."""
    per_pos = sum(resident_bytes(sh, like)
                  for sh, like in zip(cell.shardings, cell.likes))
    which = 0 if cell.kind == "train" else -1      # the state, the cache
    inplace = resident_bytes(cell.shardings[which], cell.likes[which])
    peak, g = costs["temp_peak"], cell.param_bytes
    temp = (g + (peak - g) // cell.n_shards if cell.kind == "train"
            else peak)
    return {"argument_size_in_bytes": int(per_pos.max()),
            "output_size_in_bytes": int(inplace.max()) + cell.out_bytes,
            "temp_size_in_bytes": int(max(temp, 0)),
            "alias_size_in_bytes": int(inplace.max())}


def calibrate(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
              notes: list[str]) -> dict:
    """The reference's per-layer extrapolation, as a cross-check.

    The reference compiles L1 and L2 layers unrolled because XLA's cost
    analysis counts a while-loop body once.  A traced step counts every
    op, so here body = cost(L2) - cost(L1) and rest = cost(L1) - L1 *
    body give total(L) = L * body + rest, which must equal the full
    trace's count where every layer costs the same (``run_cell`` records
    both).  The traces keep the cell's config but its depth.
    """
    L1, L2 = calib_layers(cfg)
    enc_scale = cfg.n_enc_layers // cfg.n_layers if cfg.n_enc_layers else 0
    out = []
    for Lc in (L1, L2):
        kw: dict = dict(n_layers=Lc)
        if cfg.n_enc_layers:
            kw["n_enc_layers"] = Lc * max(enc_scale, 1)
        cfg_c = dataclasses.replace(cfg, **kw)
        out.append(_cell_costs(_lower_cell(cfg_c, shape, mesh, notes)))
    c1, c2 = out
    dL = L2 - L1
    body = {k: (c2[k] - c1[k]) / dL for k in ("flops", "bytes", "coll")}
    rest = {k: c1[k] - L1 * body[k] for k in ("flops", "bytes", "coll")}
    L = cfg.n_layers
    total = {k: max(L * body[k] + rest[k], 0.0)
             for k in ("flops", "bytes", "coll")}
    return {"body": body, "rest": rest, "total": total,
            "coll_breakdown_L1": c1["coll_breakdown"],
            "seconds": c1["seconds"] + c2["seconds"]}


def meta_mesh(multi_pod: bool) -> Mesh:
    """The production mesh with ``meta`` at every position."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             overrides: dict | None = None, *, cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None, mesh: Mesh | None = None,
             mesh_name: str | None = None) -> dict:
    """One cell's row.  ``cfg``, ``shape`` and ``mesh`` (a ``meta`` mesh)
    stand in for ``arch``'s config, ``SHAPES[shape_name]`` and the
    production mesh where given (a smaller cell: the tests, and
    ``chip_smoke.py`` at its training shape)."""
    cfg0 = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = mesh_name or ("multipod" if multi_pod else "pod")
    reason = skip_reason(cfg0, shape)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    cfg = dataclasses.replace(runtime_cfg(cfg0, shape, overrides),
                              attn_impl="ref")
    mesh = mesh or meta_mesh(multi_pod)
    chips = mesh.size
    notes: list[str] = []
    t0 = time.perf_counter()
    cell = _lower_cell(cfg, shape, mesh, notes)
    t_lower = time.perf_counter() - t0
    raw = _cell_costs(cell)
    mem = _memory(cell, raw)
    note = "; ".join([NOTE] + sorted(set(notes)))
    if multi_pod:
        # the multi-pod pass proves the "pod" axis shards and the memory;
        # the roofline table is single-pod only, as the reference's
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "ok", "chips": chips, "lower_s": round(t_lower, 1),
                "trace_s": round(raw["seconds"], 1), "bytes_per_chip": mem,
                "temp_peak_all_shards": raw["temp_peak"],
                "raw": raw, "note": note + "; memory proof; roofline from "
                "the pod mesh"}
    cal = calibrate(cfg, shape, mesh, notes)
    cost = {"flops": raw["flops"], "bytes accessed": raw["bytes"]}
    coll = {**raw["coll_breakdown"], "total": raw["coll"],
            "ops": raw["coll_ops"]}
    report = analyze(arch, shape, mesh_name, chips, cost, coll, mem, cfg,
                     note=note)
    row = report.row()
    cal["matches"] = {k: (abs(cal["total"][k] - raw[k])
                          <= 1e-6 * max(abs(raw[k]), 1.0))
                      for k in ("flops", "bytes", "coll")}
    row.update({"status": "ok", "lower_s": round(t_lower, 1),
                "trace_s": round(raw["seconds"], 1),
                "calib_s": round(cal["seconds"], 1), "n_chips": chips,
                "temp_peak_all_shards": raw["temp_peak"],
                "raw": raw, "calibration": cal})
    return row


# ----------------------------------------------------------------------
# sweep orchestration (subprocess per cell for isolation/parallelism)
# ----------------------------------------------------------------------
def cell_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh}.json")


def _env() -> dict:
    """The environment of a cell's subprocess: this package importable."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def sweep(mesh_opt: str, jobs: int, force: bool = False,
          archs: list[str] | None = None) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[mesh_opt]
    cells = [(a, s, mp) for a in (archs or ARCHS) for s in SHAPES
             for mp in meshes if archs or (a, s) not in SLOW_CELLS]
    todo = [(a, s, mp) for a, s, mp in cells
            if force or not os.path.exists(
                cell_path(a, s, "multipod" if mp else "pod"))]
    print(f"{len(todo)}/{len(cells)} cells to run, {jobs} parallel jobs")

    def launch(cell):
        a, s, mp = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               a, "--shape", s, "--mesh", "multipod" if mp else "pod"]
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, env=_env())

    queue = list(todo)
    running: list[tuple] = []
    while queue or running:
        while queue and len(running) < jobs:
            cell = queue.pop(0)
            running.append((cell, launch(cell), time.time()))
            print(f"  start {cell}")
        time.sleep(2)
        for item in list(running):
            cell, proc, t0 = item
            rc = proc.poll()
            if rc is None:
                continue
            running.remove(item)
            dt = time.time() - t0
            if rc == 0:
                print(f"  done  {cell} ({dt:.0f}s)")
            else:
                err = proc.stderr.read().decode()[-4000:]
                print(f"  FAIL  {cell} rc={rc} ({dt:.0f}s)\n{err[-800:]}")
                a, s, mp = cell
                path = cell_path(a, s, "multipod" if mp else "pod")
                if not os.path.exists(path):  # never clobber a good row
                    with open(path, "w") as f:
                        json.dump({"arch": a, "shape": s,
                                   "mesh": "multipod" if mp else "pod",
                                   "status": "fail", "rc": rc,
                                   "error": err}, f)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig overrides (perf knobs)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.sweep:
        sweep(args.mesh, args.jobs, args.force,
              [args.arch] if args.arch else None)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    overrides = json.loads(args.overrides) if args.overrides else None
    for mp in ({"pod": [False], "multipod": [True],
                "both": [False, True]}[args.mesh]):
        mesh_name = "multipod" if mp else "pod"
        try:
            row = run_cell(args.arch, args.shape, mp, overrides)
        except Exception:
            row = {"arch": args.arch, "shape": args.shape,
                   "mesh": mesh_name, "status": "fail",
                   "error": traceback.format_exc()[-4000:]}
        os.makedirs(OUT_DIR, exist_ok=True)
        path = args.out or cell_path(args.arch, args.shape, mesh_name)
        with open(path, "w") as f:
            json.dump(row, f, indent=1, default=str)
        status = row["status"]
        print(f"{args.arch} {args.shape} {mesh_name}: {status}")
        if status == "ok" and "t_compute" in row:
            print(f"  Tc={row['t_compute']*1e3:.3f}ms "
                  f"Tm={row['t_memory']*1e3:.3f}ms "
                  f"Tx={row['t_collective']*1e3:.3f}ms "
                  f"dom={row['dominant']} useful={row['useful_ratio']:.3f} "
                  f"traced in {row['trace_s']} s")
            print(f"  mem/device: {row['bytes_per_chip']}")
        elif status == "fail":
            print(row["error"][-1500:])
            sys.exit(1)


if __name__ == "__main__":
    main()
