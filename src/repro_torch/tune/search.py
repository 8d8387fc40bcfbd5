"""Profile-guided schedule search: the model ranks, the card picks.

Port of :mod:`repro.tune.search`, with the reference's protocol:

1. **prior** — the analytic sweep ranks candidates per fusion group
   (top-k widths by modeled time) so the measured search starts at the
   model's pick;
2. **measure** — each surviving candidate is lowered, its kernels
   built, and timed on the app's device (:func:`default_measure`);
3. **pick** — coordinate descent over the per-group vector factors
   (tile width ``32 * vf``), the ``max_tile`` height cap and the fusion
   budget, capped at ``max_trials`` measurements.  The analytic pick is
   measured first, so the winner is **never slower than the analytic
   schedule** in the search's own measurements;
4. **persist** — the winner goes into the on-disk
   :class:`~repro_torch.tune.store.TuningCache`; the next
   ``compile_graph(..., tune="auto")`` of the same app on the same card
   makes **zero** measurements.

What the card changes: a candidate's tile is a compile-time constant of
its generated kernel, so each candidate is an nvcc build.  The search
builds the candidates of one round (one group's widths, the height
caps, the budgets) together, one nvcc each, all at once, before timing
any of them; build time is counted (``n_builds``, ``build_s``) and
never part of a measurement.  A failed build or launch propagates; only
a tile the model finds infeasible is skipped.  Candidates whose tiles
and partition equal one already measured are skipped too (a height cap
above the model's pick changes nothing).

Doctest (fake measurements, so it runs anywhere — real use omits
``measure``):

    >>> import tempfile
    >>> from repro_torch.core.graph import DataflowGraph
    >>> from repro_torch.tune.store import TuningCache
    >>> g = DataflowGraph("doc")
    >>> x = g.input("img", (64, 256))
    >>> _ = g.output(g.point(x, lambda v: v * 2.0), "out")
    >>> cache = TuningCache(tempfile.mkdtemp())
    >>> res = tune_graph(g, "torch", device="cpu", cache=cache, top_k=8,
    ...                  measure=lambda cfg: 1.0 / cfg.group_vf[0])
    >>> res.source, res.config.group_vf         # widest factor is fastest
    ('measured', (8,))
    >>> again = tune_graph(g, "torch", device="cpu", cache=cache,
    ...                    measure=lambda cfg: 1.0 / cfg.group_vf[0])
    >>> again.source, again.n_measurements      # served from disk
    ('cache', 0)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.schedule import Schedule, build_schedule
from repro_torch.core.vectorize import (DEFAULT_MAX_TILE, H100, GPUSpec,
                                        device_spec, modeled_schedule_time,
                                        scale_spec, schedule_features,
                                        sweep_vector_factor)
from repro_torch.obs.drift import DriftLog, resolve_drift
from repro_torch.obs.tracer import maybe_span, resolve_tracer
from repro_torch.tune.store import (ScheduleConfig, TuningCache, TuningKey,
                                    TuningRecord, detect_device_kind,
                                    device_mode)

__all__ = ["Trial", "TuningResult", "tune_graph", "resolve_tuning",
           "default_measure", "tuned_schedule_kwargs", "CardTimer",
           "MAX_TILE_CANDIDATES"]

#: the height axis of the search: caps over the heights of the tile
#: grid (8-64); the first is the analytic default
MAX_TILE_CANDIDATES = (DEFAULT_MAX_TILE, (32, 256), (16, 256), (8, 256))

#: bytes written to flush the card's 50 MB L2 before each timed run
_FLUSH_BYTES = 64 * 2**20


def tuned_schedule_kwargs(config: ScheduleConfig, source: str,
                          spec: GPUSpec = H100) -> dict:
    """:func:`~repro_torch.core.schedule.build_schedule` kwargs for a
    config: the one mapping from a tuned :class:`ScheduleConfig` onto
    the scheduler's knobs."""
    return dict(spec=scale_spec(spec, config.vmem_fraction),
                group_vector_factors=config.group_vf,
                max_tile=config.max_tile, tile_source=source)


class CardTimer:
    """Device seconds of one call on the card, best of ``reps``.

    CUDA events around each run, a spin kernel queued before it so the
    host's enqueue time is hidden, and the L2 cache flushed before each
    run (a frame arrives cold; a warm L2 would hold a whole 1080x1920
    float32 plane and misrank the byte-bound tiles).  Three untimed
    calls warm the call up first (a kernel's library is loaded then).
    """

    def __init__(self, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8,
                                 device=self.device)

    def __call__(self, fn: Callable[[], Any], reps: int = 3) -> float:
        with torch.cuda.device(self.device):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            spin = int(max(2e-3, 3 * enqueue_s) * 2e9)   # cycles, <= 2 GHz
            pairs = []
            for _ in range(reps):
                self.flush.zero_()
                torch.cuda._sleep(spin)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
        return min(s.elapsed_time(e) for s, e in pairs) * 1e-3


@dataclasses.dataclass
class Trial:
    """One measured candidate of the search."""

    label: str
    config: ScheduleConfig
    modeled_s: float
    measured_s: float


@dataclasses.dataclass
class TuningResult:
    """Outcome of :func:`tune_graph` for one ``(graph, backend, device)``."""

    key: TuningKey
    config: ScheduleConfig
    #: "measured" (fresh search) or "cache" (loaded, zero measurements)
    source: str
    trials: list[Trial]
    n_measurements: int
    record: TuningRecord
    #: candidates skipped on the calibrated prior without measuring
    n_pruned: int = 0
    #: kernel libraries built for the candidates, and the seconds spent
    #: building them (never part of a measurement)
    n_builds: int = 0
    build_s: float = 0.0

    def notes(self) -> list[str]:
        """Provenance lines for ``Schedule.diagnostics``."""
        lines = [f"[tune] source={self.source} backend={self.key.backend} "
                 f"device={self.key.device_kind} mode={self.key.mode} "
                 f"{self.config.describe()}"]
        if self.source == "cache":
            lines.append(f"[tune] loaded from TuningCache "
                         f"({self.n_measurements} measurements)")
            return lines
        best = self.record.best_measured_s
        base = self.record.analytic_measured_s
        if best and base is not None:
            lines.append(
                f"[tune] measured {self.n_measurements} candidates: "
                f"best={best * 1e6:.1f}us analytic={base * 1e6:.1f}us "
                f"({base / best:.2f}x); built {self.n_builds} kernels in "
                f"{self.build_s:.2f}s")
        if self.n_pruned:
            lines.append(f"[tune] calibrated prior pruned "
                         f"{self.n_pruned} candidates unmeasured")
        return lines


def _tuning_context(spec: GPUSpec, strict: bool, canonicalize: bool,
                    passes) -> str:
    """Digest of everything besides graph/backend/device that changes
    what a measurement means: the spec's constants and the
    canonicalization regime (strict/point fusion change the partition a
    config's ``group_vf`` refers to)."""
    blob = json.dumps([sorted((f, repr(getattr(spec, f)))
                              for f in spec.__dataclass_fields__),
                       bool(strict), bool(canonicalize),
                       [type(p).__name__ for p in passes]
                       if passes is not None else None])
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def default_measure(graph, backend, config: ScheduleConfig, *,
                    spec: GPUSpec | None = None, reps: int = 3,
                    device: Any = None, seed: int = 0, strict: bool = False,
                    canonicalize: bool = True, passes=None,
                    app: Any = None) -> float:
    """Lower ``graph`` under ``config`` and time it on its device.

    Compiles through :func:`repro_torch.core.compiler.compile_graph`
    with the explicit config (no recursion into the tuner) unless the
    compiled ``app`` is passed, makes inputs of the declared shapes from
    ``seed`` on the device, and returns the best-of-``reps`` seconds of
    one call.  On the card the inputs stay resident and a call is timed
    by :class:`CardTimer` (CUDA events, L2 flushed, enqueue hidden): the
    reference's host clock around the call and a readback would time the
    copy to the host, not the kernels.  On the CPU the plain versions
    are timed on the host clock after one warm-up call.
    """
    from repro_torch.backends import resolve
    from repro_torch.core.compiler import compile_graph
    from repro_torch.core.graph import as_dtype
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if app is None:
        app = compile_graph(graph, resolve(backend), tune=config, spec=spec,
                            strict=strict, canonicalize=canonicalize,
                            passes=passes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = {c.name: torch.randn(c.shape, generator=gen, device=dev)
              .to(as_dtype(c.dtype)) for c in app.graph.graph_inputs}

    def call() -> None:
        app(**inputs)

    if dev.type == "cuda":
        return CardTimer(dev)(call, reps)
    call()                                   # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return min(times)


class _Harness:
    """The default measuring path: compiles each candidate once, builds
    a round's kernels in one parallel call, times through the backend's
    ``measure`` hook (the seeds': :func:`default_measure`)."""

    def __init__(self, graph, be, hook: Callable, dev: torch.device,
                 measure_kwargs: dict, compile_kwargs: dict):
        self.graph, self.be, self.hook, self.dev = graph, be, hook, dev
        self.measure_kwargs = measure_kwargs
        self.compile_kwargs = compile_kwargs
        self.apps: dict[ScheduleConfig, Any] = {}
        self.n_builds = 0
        self.build_s = 0.0

    def prepare(self, configs: Sequence[ScheduleConfig]) -> None:
        from repro_torch.core.compiler import compile_graph
        from repro_torch.kernels.stream_group import build_kernels
        for cfg in configs:
            if cfg not in self.apps:
                self.apps[cfg] = compile_graph(self.graph, self.be, tune=cfg,
                                               device=self.dev,
                                               **self.compile_kwargs)
        kernels = [k for cfg in configs for k in self.apps[cfg].kernels]
        if self.dev.type == "cuda" and kernels:
            t0 = time.perf_counter()
            self.n_builds += build_kernels(kernels)
            self.build_s += time.perf_counter() - t0

    def __call__(self, cfg: ScheduleConfig) -> float:
        return self.hook(self.graph, self.be, cfg, device=self.dev,
                         app=self.apps.get(cfg), **self.measure_kwargs)


def _plan(sched: Schedule) -> tuple:
    """What a candidate runs: its partition and each group's tile."""
    return tuple((tuple(s.name for s in g.stages), g.tile)
                 for g in sched.groups)


def _model_config(graph, spec: GPUSpec, max_tile: tuple[int, int],
                  vmem_fraction: float,
                  build_kwargs: dict) -> tuple[ScheduleConfig, Schedule]:
    """The analytic pick under one (max_tile, budget) point, as a config."""
    sched = build_schedule(graph, spec=scale_spec(spec, vmem_fraction),
                           max_tile=max_tile, **build_kwargs)
    vfs = tuple(None if g.is_trivial else g.vector_factor
                for g in sched.groups)
    return (ScheduleConfig(group_vf=vfs, max_tile=max_tile,
                           vmem_fraction=vmem_fraction), sched)


def _scored(graph, cfg: ScheduleConfig, spec: GPUSpec,
            build_kwargs: dict, sched: Schedule | None = None) -> tuple:
    """(modeled seconds, drift features, plan) of one candidate."""
    if sched is None:
        sched = build_schedule(graph, **tuned_schedule_kwargs(
            cfg, "measured", spec), **build_kwargs)
    return (modeled_schedule_time(sched, spec),
            schedule_features(sched, spec=spec), _plan(sched))


def tune_graph(graph, backend="cuda_stream", *,
               spec: GPUSpec | None = None,
               cache: TuningCache | None = None, device: Any = None,
               device_kind: str | None = None, top_k: int = 3,
               max_trials: int = 12, reps: int = 3,
               measure: Callable[[ScheduleConfig], float] | None = None,
               seed: int = 0, strict: bool = False,
               canonicalize: bool = True, passes=None,
               max_tile_candidates: Sequence[tuple[int, int]] = (
                   MAX_TILE_CANDIDATES),
               vmem_fractions: Sequence[float] = (1.0,),
               force: bool = False, trace: Any = None,
               drift: Any = None, calibrate: Any = None,
               prior_ratio: float | None = 1.3) -> TuningResult:
    """Search the schedule space for ``graph`` by measuring candidates.

    The search space is the per-group vector factor (the top-``top_k``
    widths by the analytic model, each at the model's best height), the
    ``max_tile`` height cap and the fusion budget (``vmem_fractions`` of
    the card's shared memory per block).  ``measure`` maps a
    :class:`ScheduleConfig` to seconds per call; the default lowers,
    builds and times on ``device`` (default the card; ``"cpu"`` times the
    plain versions) through the backend's ``measure`` hook — tests
    inject deterministic fakes.  At most ``max_trials`` measurements
    run; the analytic pick is always the first, so the returned winner
    is never slower than it (as measured).  Results persist in ``cache``
    keyed by graph signature, backend, device kind, input shapes and
    mode (card or plain); a hit returns at once with
    ``n_measurements == 0``.

    ``trace`` wraps every measurement in a ``tune.trial`` span; each
    trial also appends a ``kind="trial"`` (modeled, measured) row with
    the candidate's cost-model features to the drift log beside the
    cache (``drift.jsonl`` under ``cache.root``; ``drift=False``
    disables it, a :class:`~repro_torch.obs.drift.DriftLog` or path
    redirects it) — the rows the calibration fit consumes.

    ``calibrate`` (the ``compile_graph`` protocol) swaps in the fitted
    :class:`~repro_torch.tune.calibrate.CalibratedSpec` for this backend
    and device kind.  Only a calibrated spec (one with ``ii_scale``)
    prunes: a candidate whose modeled time exceeds ``prior_ratio`` times
    the best modeled time seen so far is skipped unmeasured (counted in
    ``n_pruned``).  The seed model has not earned that trust.
    """
    from repro_torch.backends import resolve_calibrated
    dev = torch.device("cuda" if device is None else device)
    device_kind = device_kind or detect_device_kind(dev)
    be = resolve_calibrated(backend, calibrate, device_kind=device_kind)
    be.require("tuning", context=f"tune_graph({graph.name!r})")
    spec = spec or be.spec or device_spec(dev)
    prune = bool(getattr(spec, "ii_scale", ())) and prior_ratio is not None
    # NOT `cache or ...`: an empty TuningCache is falsy (__len__ == 0)
    cache = cache if cache is not None else TuningCache()
    tracer = resolve_tracer(trace)
    drift_log = (DriftLog(os.path.join(cache.root, "drift.jsonl"))
                 if drift is None else resolve_drift(drift))
    # the measured program must BE the compiled program: the compile
    # flags ride in both the search and the cache key
    build_kwargs = dict(strict=strict, canonicalize=canonicalize,
                        passes=passes)
    context = _tuning_context(spec, strict, canonicalize, passes)
    mode = device_mode(dev)
    key_pre = TuningKey.for_graph(graph, be, device_kind, mode=mode,
                                  context=context)
    if not force:
        rec = cache.get(key_pre)
        if rec is not None:
            return TuningResult(key_pre, rec.config, "cache", [], 0, rec)

    harness = None
    if measure is None:
        hook = be.measure if be.measure is not None else default_measure
        harness = _Harness(graph, be, hook, dev,
                           dict(spec=spec, reps=reps, seed=seed,
                                **build_kwargs),
                           dict(spec=spec, **build_kwargs))
        measure = harness

    counter = {"n": 0, "pruned": 0}
    trials: list[Trial] = []
    seen: set[tuple] = set()
    best_modeled = [float("inf")]

    def plan_round(cands: list[tuple]) -> list[tuple]:
        """The candidates of one round to measure, in order: not seen,
        within ``max_trials``, not pruned by a calibrated prior."""
        out = []
        for label, cfg, (mod_s, feats, plan) in cands:
            if plan in seen or counter["n"] + len(out) >= max_trials:
                continue
            seen.add(plan)
            if mod_s > 0:
                best_modeled[0] = min(best_modeled[0], mod_s)
            if prune and mod_s > prior_ratio * best_modeled[0]:
                counter["pruned"] += 1
                continue
            out.append((label, cfg, mod_s, feats))
        return out

    def run_round(cands: list[tuple], best: Trial | None) -> Trial | None:
        todo = plan_round(cands)
        if harness is not None and todo:
            harness.prepare([cfg for _, cfg, _, _ in todo])
        for label, cfg, mod_s, feats in todo:
            with maybe_span(tracer, "tune.trial", cat="tune",
                            graph=graph.name, label=label) as sp:
                counter["n"] += 1
                measured_s = measure(cfg)
                sp.set(modeled_s=mod_s, measured_s=measured_s)
            t = Trial(label, cfg, mod_s, measured_s)
            trials.append(t)
            if drift_log is not None:
                drift_log.record("trial", drift_sig, drift_shapes, be.name,
                                 mod_s, measured_s, label=label,
                                 device=device_kind, mode=mode,
                                 features=feats)
            if best is None or t.measured_s < best.measured_s:
                best = t
        return best

    # ---- analytic baseline: the model's pick, measured first --------
    baseline_cfg, baseline_sched = _model_config(
        graph, spec, tuple(max_tile_candidates[0]), 1.0, build_kwargs)
    # canonicalization may have rewritten the graph in place: alias the
    # post-canonicalization signature so either form hits later
    key_post = TuningKey.for_graph(baseline_sched.graph, be, device_kind,
                                   mode=mode, context=context)
    tunable = [i for i, g in enumerate(baseline_sched.groups)
               if not g.is_trivial]
    drift_sig = baseline_sched.graph.signature()
    drift_shapes = [list(c.shape) for c in baseline_sched.graph.graph_inputs]

    if not tunable:                      # nothing to search: model wins
        rec = TuningRecord(config=baseline_cfg, source="measured",
                           modeled_s=0.0, n_trials=0)
        cache.put(key_post, rec, aliases=(key_pre,))
        return TuningResult(key_pre, baseline_cfg, "measured", [], 0, rec)

    best = run_round([("analytic", baseline_cfg,
                       _scored(graph, baseline_cfg, spec, build_kwargs,
                               baseline_sched))], None)
    analytic = best

    # ---- axis 1: per-group vector factor (coordinate descent) ------
    for gi in tunable:
        records = sweep_vector_factor(baseline_sched.groups[gi], spec,
                                      max_tile=baseline_cfg.max_tile)
        feasible = sorted((r for r in records if r["feasible"]),
                          key=lambda r: r["modeled_s"])
        cands = []
        for r in feasible[:top_k]:
            vfs = list(best.config.group_vf)
            vfs[gi] = r["vector_factor"]
            cfg = dataclasses.replace(best.config, group_vf=tuple(vfs))
            cands.append((f"g{gi}:vf{r['vector_factor']}", cfg,
                          _scored(graph, cfg, spec, build_kwargs)))
        best = run_round(cands, best)

    # ---- axis 2: tile-height cap ------------------------------------
    cands = []
    for mt in max_tile_candidates[1:]:
        cfg = dataclasses.replace(best.config, max_tile=tuple(mt))
        cands.append((f"max_tile{tuple(mt)}", cfg,
                      _scored(graph, cfg, spec, build_kwargs)))
    best = run_round(cands, best)

    # ---- axis 3: fusion budget (changes the partition itself) -------
    cands = []
    for frac in vmem_fractions:
        if frac == 1.0:
            continue
        cfg, sched = _model_config(graph, spec, best.config.max_tile, frac,
                                   build_kwargs)
        cands.append((f"vmem{frac:g}", cfg,
                      _scored(graph, cfg, spec, build_kwargs, sched)))
    best = run_round(cands, best)

    n_builds = harness.n_builds if harness is not None else 0
    build_s = harness.build_s if harness is not None else 0.0
    rec = TuningRecord(config=best.config, source="measured",
                       best_measured_s=best.measured_s,
                       analytic_measured_s=analytic.measured_s,
                       modeled_s=best.modeled_s, n_trials=counter["n"],
                       n_pruned=counter["pruned"])
    cache.put(key_post, rec, aliases=(key_pre,))
    if drift_log is not None:
        drift_log.flush()       # trial rows persist with the record
    return TuningResult(key_pre, best.config, "measured", trials,
                        counter["n"], rec, n_pruned=counter["pruned"],
                        n_builds=n_builds, build_s=build_s)


def resolve_tuning(graph, backend, *, tune: Any,
                   spec: GPUSpec | None = None,
                   cache: TuningCache | None = None, device: Any = None,
                   **tune_kwargs: Any) -> tuple[ScheduleConfig, str,
                                                list[str]] | None:
    """Normalize a ``tune=`` argument into ``(config, source, notes)``.

    - ``None`` / ``"model"`` — no tuning (analytic sweep); returns None,
    - a :class:`ScheduleConfig` — apply verbatim (source ``"config"``),
    - ``"auto"`` — consult the :class:`TuningCache`, searching with
      :func:`tune_graph` on a miss (source ``"measured"`` or
      ``"cache"``).
    """
    if tune is None or tune == "model":
        return None
    if isinstance(tune, ScheduleConfig):
        return (tune, "config",
                [f"[tune] source=config {tune.describe()}"])
    if tune == "auto":
        result = tune_graph(graph, backend, spec=spec, cache=cache,
                            device=device, **tune_kwargs)
        return result.config, result.source, result.notes()
    raise ValueError(
        f"tune must be None, 'model', 'auto' or a ScheduleConfig; "
        f"got {tune!r}")
