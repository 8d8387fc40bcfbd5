"""Cost-model calibration: fit the spec's constants from drift logs.

Port of :mod:`repro.tune.calibrate`, fitted to the port's model
(:func:`repro_torch.core.vectorize.modeled_plane_time`), which prices
a fusion group as

``t = max(blocks * bytes_block / (hbm_bw * fill),
blocks * sum_kind(ops_block[kind] * ii_scale[kind]) / (fp32_flops * fill))
+ waves * wave_overhead_s``

with data-sheet constants in :class:`~repro_torch.core.vectorize.GPUSpec`.
Every drift row with features (the tuner's ``trial`` rows, the engine's
``launch`` rows) carries the terms behind its modeled time, which makes
the model **linear** once each group's ``max(memory, compute)`` branch
is decided: in ``theta = [wave_overhead_s, 1/hbm_bw, alpha_kind]`` with
``alpha_kind = ii_scale[kind] / fp32_flops``, over the columns
``waves``, ``blocks * bytes_block / fill`` and ``blocks *
ops_block[kind] / fill``.  ``fill`` — the share of the card's memory
parallelism the resident warps use, a nonlinear function of
``saturating_warps_per_sm`` — is kept as each row recorded it and is
not refitted.  :func:`calibrate` solves the problem with the
reference's alternating active set:

1. canonicalize rows (drop unusable, dedupe exact duplicates, sort) —
   the fit is invariant to row order and duplication;
2. under the current constants, mark each group memory- or
   compute-bound;
3. solve the least-squares problem with rows scaled by ``1/measured``
   (relative error: a 4 ms blur and a 40 us copy weigh the same), drop
   all-zero columns (their constants keep seed values), clamp
   nonphysical negatives; optionally Huber-reweighted;
4. repeat until the branch assignment stops changing.

Too few rows or a rank-deficient design **falls back to the seed spec
with a warning — never NaN constants**; the engine's ``compile`` rows
(whose measured time includes building the kernels) are excluded by
default.

The result is a :class:`CalibratedSpec` — a frozen
:class:`~repro_torch.core.vectorize.GPUSpec` subclass carrying the
fitted constants plus a per-stage-kind ``ii_scale`` — persisted beside
the :class:`~repro_torch.tune.store.TuningCache` (atomic JSON, keyed by
backend ``cache_key()`` and device kind, versioned) by
:class:`CalibrationStore` and resolved into compiles by
:func:`repro_torch.backends.resolve_calibrated` /
``compile_graph(calibrate="auto")``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import warnings
from typing import Any, Iterable

import numpy as np

from repro_torch.core.vectorize import H100, GPUSpec
from repro_torch.obs.drift import DriftLog, DriftRow
from repro_torch.tune.store import (default_cache_root, detect_device_kind,
                                    remove_json_files, write_json_atomic)

__all__ = ["CalibratedSpec", "CalibrationResult", "CalibrationStore",
           "calibrate", "calibrate_backend", "load_calibration",
           "resolve_calibration", "spec_to_json", "spec_from_json",
           "CALIBRATION_VERSION", "MIN_ROWS"]

#: bump when the fit/record format changes; readers skip other versions
CALIBRATION_VERSION = 1

#: prior fits kept in a record's ``history`` chain (freshest first)
_HISTORY_KEEP = 8

#: below this many usable rows the fit refuses and keeps the seed spec
MIN_ROWS = 8

#: maximum alternating (branch-assign / solve) iterations
_MAX_ITER = 25


@dataclasses.dataclass(frozen=True)
class CalibratedSpec(GPUSpec):
    """A :class:`~repro_torch.core.vectorize.GPUSpec` with fitted constants.

    Being a subclass is the whole trick: every consumer that threads a
    spec (tile sweep, partitioner budget, tuner prior, backend cache
    key) picks up the calibrated constants with no new plumbing.
    ``ii_scale`` is a tuple of ``(stage_kind, multiplier)`` pairs
    (hashable for the frozen dataclass); the model multiplies each stage
    kind's operations by it.

    >>> s = CalibratedSpec(ii_scale=(("stencil", 2.0),), n_rows=12)
    >>> dict(s.ii_scale)["stencil"]
    2.0
    >>> isinstance(s, GPUSpec)
    True
    """

    #: per-stage-kind operation multipliers, sorted by kind
    ii_scale: tuple = ()
    #: drift rows the fit consumed (provenance, not behaviour)
    n_rows: int = 0
    #: fit/record format version
    calibration_version: int = CALIBRATION_VERSION


def spec_to_json(spec: GPUSpec) -> dict[str, Any]:
    """JSON-ready dict of every dataclass field (ii_scale as lists)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "ii_scale":
            v = [[k, s] for k, s in v]
        out[f.name] = v
    return out


def spec_from_json(d: dict[str, Any]) -> CalibratedSpec:
    """Inverse of :func:`spec_to_json` (unknown keys are ignored).

    >>> s = CalibratedSpec(fp32_flops=2e13, ii_scale=(("point", 1.5),))
    >>> spec_from_json(spec_to_json(s)) == s
    True
    """
    fields = {f.name for f in dataclasses.fields(CalibratedSpec)}
    kw = {k: v for k, v in d.items() if k in fields}
    if "ii_scale" in kw:
        kw["ii_scale"] = tuple((str(k), float(s)) for k, s in kw["ii_scale"])
    return CalibratedSpec(**kw)


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of one fit: the spec to use plus an audit trail.

    ``fitted`` False means the fallback path ran (``spec`` is the seed
    spec, ``warning`` says why); either way ``spec`` is usable and
    finite — callers never need to re-check for NaN.
    """

    spec: GPUSpec
    fitted: bool
    n_rows: int = 0               #: usable rows the fit consumed
    n_excluded: int = 0           #: rows dropped by kind (build-polluted)
    n_unusable: int = 0           #: rows without features / nonfinite
    n_duplicates: int = 0         #: exact duplicates collapsed
    iterations: int = 0
    warning: str | None = None
    #: fitted parameters (theta), for introspection and tests
    params: dict[str, float] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        if not self.fitted:
            return f"calibration fallback ({self.warning})"
        s = self.spec
        scales = ",".join(f"{k}={v:.3g}" for k, v in
                          getattr(s, "ii_scale", ()))
        return (f"calibrated from {self.n_rows} rows: "
                f"fp32_flops={s.fp32_flops:.3g}/s hbm_bw={s.hbm_bw:.3g}B/s "
                f"wave_overhead={s.wave_overhead_s:.3g}s ii_scale[{scales}]")


# ----------------------------------------------------------------------
# row canonicalization
# ----------------------------------------------------------------------

def _group_terms(g: dict) -> tuple[float, float, dict[str, float]]:
    """One group's linear columns: waves, memory, compute per kind."""
    blocks, fill = float(g["blocks"]), float(g["fill"])
    ops = g["ops_block"]
    if not isinstance(ops, dict) or blocks <= 0 or not fill > 0:
        raise ValueError("not a per-kind feature row")
    return (float(g["waves"]), blocks * float(g["bytes_block"]) / fill,
            {str(k): blocks * float(v) / fill for k, v in sorted(ops.items())})


def _canon_rows(rows: Iterable[DriftRow],
                exclude_kinds: tuple[str, ...]) -> tuple[list, int, int, int]:
    """Filter, dedupe and sort rows into fit inputs.

    Returns ``(fit_rows, n_excluded, n_unusable, n_duplicates)`` where
    each fit row is ``(measured_s, items, groups)`` with ``groups`` a
    list of ``(waves, memory column, {kind: compute column})``.  Rows
    written before the operations were split by kind (a scalar
    ``ops_block``) are unusable.  Exact duplicates collapse to one and
    the survivors are sorted by their canonical JSON encoding, so the
    solution is independent of input order and duplication, bit for bit.
    """
    n_excluded = n_unusable = 0
    keyed: dict[str, tuple] = {}
    n_seen = 0
    for r in rows:
        if r.kind in exclude_kinds:
            n_excluded += 1
            continue
        feats = r.features
        if (feats is None or not feats.get("groups")
                or not np.isfinite(r.measured_s) or r.measured_s <= 0):
            n_unusable += 1
            continue
        try:
            groups = [_group_terms(g) for g in feats["groups"]]
        except (KeyError, TypeError, ValueError):
            n_unusable += 1
            continue
        if not all(np.isfinite([w, m, *c.values()]).all()
                   for w, m, c in groups):
            n_unusable += 1
            continue
        row = (float(r.measured_s), int(feats.get("items", 1)), groups)
        n_seen += 1
        keyed[json.dumps(row, sort_keys=True)] = row
    n_duplicates = n_seen - len(keyed)
    fit_rows = [keyed[k] for k in sorted(keyed)]
    return fit_rows, n_excluded, n_unusable, n_duplicates


# ----------------------------------------------------------------------
# the fit
# ----------------------------------------------------------------------

def _assign_branches(fit_rows: list, theta_b: float,
                     alpha: dict[str, float]) -> list[list[bool]]:
    """Per row, per group: True when memory-bound under current theta."""
    return [[mem * theta_b >= sum(c[k] * alpha.get(k, 0.0) for k in c)
             for _, mem, c in groups] for _, _, groups in fit_rows]


def calibrate(rows: Iterable[DriftRow] | DriftLog,
              spec: GPUSpec | None = None, *,
              min_rows: int = MIN_ROWS,
              exclude_kinds: tuple[str, ...] = ("compile",),
              huber_delta: float | None = None,
              max_iter: int = _MAX_ITER) -> CalibrationResult:
    """Fit a :class:`CalibratedSpec` from drift rows.

    ``rows`` is a :class:`~repro_torch.obs.drift.DriftLog` or an
    iterable of :class:`~repro_torch.obs.drift.DriftRow`; only rows
    carrying per-kind features and a finite positive ``measured_s``
    participate.  ``spec`` seeds the iteration and supplies every
    constant the data cannot identify (default
    :data:`~repro_torch.core.vectorize.H100`).

    ``exclude_kinds`` drops rows whose measured time is not a clean
    launch — by default the engine's ``compile`` rows, which include
    building the kernels.  Pass ``()`` to fit on everything.

    ``huber_delta`` (in units of relative residual, e.g. ``3.0``)
    switches the final solve to Huber IRLS so a few wild outliers
    cannot dominate; ``None`` keeps plain least squares, which is
    exactly recoverable in tests.

    Never raises on bad data and never returns NaN constants: with
    fewer than ``min_rows`` usable rows, or a design that cannot
    identify the remaining constants (rank-deficient), the seed
    ``spec`` comes back with ``fitted=False`` and a warning.
    """
    seed = spec if spec is not None else H100
    if isinstance(rows, DriftLog):
        rows = rows.rows()
    fit_rows, n_excl, n_bad, n_dup = _canon_rows(tuple(rows),
                                                 tuple(exclude_kinds))

    def fallback(why: str) -> CalibrationResult:
        warnings.warn(f"calibration fell back to the seed spec: {why}",
                      RuntimeWarning, stacklevel=2)
        return CalibrationResult(spec=seed, fitted=False,
                                 n_rows=len(fit_rows), n_excluded=n_excl,
                                 n_unusable=n_bad, n_duplicates=n_dup,
                                 warning=why)

    if len(fit_rows) < min_rows:
        return fallback(f"{len(fit_rows)} usable rows < min_rows="
                        f"{min_rows} ({n_bad} without features/nonfinite, "
                        f"{n_excl} excluded by kind)")

    kinds = sorted({k for _, _, groups in fit_rows
                    for _, _, c in groups for k in c})
    if not kinds:
        return fallback("no stage operations in any row")

    # seed theta: overhead, 1/bw, and alpha_k = ii_scale_k / fp32_flops
    seed_scale = dict(getattr(seed, "ii_scale", ()) or ())
    theta_o = float(seed.wave_overhead_s)
    theta_b = 1.0 / float(seed.hbm_bw)
    alpha = {k: seed_scale.get(k, 1.0) / float(seed.fp32_flops)
             for k in kinds}

    branches = _assign_branches(fit_rows, theta_b, alpha)
    cols = ["overhead", "bw"] + kinds
    iterations = 0
    for iterations in range(1, max_iter + 1):
        A = np.zeros((len(fit_rows), len(cols)))
        y = np.ones(len(fit_rows))
        for i, (measured, items, groups) in enumerate(fit_rows):
            w = items / measured          # relative-error weighting
            for (waves, mem, comp), on_mem in zip(groups, branches[i]):
                A[i, 0] += w * waves
                if on_mem:
                    A[i, 1] += w * mem
                else:
                    for k, v in comp.items():
                        A[i, 2 + kinds.index(k)] += w * v
        live = [j for j in range(len(cols)) if np.any(A[:, j] != 0.0)]
        if not live:
            return fallback("design matrix is all zeros")
        sol, _, rank, _ = np.linalg.lstsq(A[:, live], y, rcond=None)
        if rank < len(live):
            return fallback(
                f"rank-deficient design (rank {rank} < {len(live)} "
                f"identifiable constants); need more workload variety")
        if not np.all(np.isfinite(sol)):
            return fallback("solver returned non-finite constants")
        if huber_delta is not None:
            # IRLS: down-weight rows whose relative residual exceeds
            # delta, re-solve until the weights settle
            wts = np.ones(len(fit_rows))
            for _ in range(10):
                res = A[:, live] @ sol - y
                new = np.where(np.abs(res) <= huber_delta, 1.0,
                               huber_delta / np.maximum(np.abs(res), 1e-30))
                if np.allclose(new, wts):
                    break
                wts = new
                sw = np.sqrt(wts)
                sol, _, rank, _ = np.linalg.lstsq(
                    A[:, live] * sw[:, None], y * sw, rcond=None)
                if rank < len(live) or not np.all(np.isfinite(sol)):
                    return fallback("robust re-solve degenerated")
        # scatter the solution back; dead columns keep their value
        new_o, new_b, new_alpha = theta_o, theta_b, dict(alpha)
        for j, v in zip(live, sol):
            if cols[j] == "overhead":
                new_o = max(float(v), 0.0)       # can't owe time back
            elif cols[j] == "bw":
                new_b = float(v) if v > 0 else theta_b
            else:
                new_alpha[cols[j]] = float(v) if v > 0 else alpha[cols[j]]
        theta_o, theta_b, alpha = new_o, new_b, new_alpha
        new_branches = _assign_branches(fit_rows, theta_b, alpha)
        if new_branches == branches:
            break
        branches = new_branches

    # theta back into spec constants: the kind with the largest total
    # operation mass pins fp32_flops; the others become multipliers
    mass = {k: 0.0 for k in kinds}
    for _, items, groups in fit_rows:
        for _, _, comp in groups:
            for k, v in comp.items():
                mass[k] += items * v
    ref = max(kinds, key=lambda k: (mass[k], k))
    flops = 1.0 / alpha[ref] if alpha[ref] > 0 else float(seed.fp32_flops)
    ii_scale = tuple((k, 1.0 if k == ref else alpha[k] * flops)
                     for k in kinds)
    fitted = dataclasses.replace(
        CalibratedSpec(**{f.name: getattr(seed, f.name)
                          for f in dataclasses.fields(GPUSpec)}),
        fp32_flops=flops, hbm_bw=1.0 / theta_b, wave_overhead_s=theta_o,
        ii_scale=ii_scale, n_rows=len(fit_rows),
        calibration_version=CALIBRATION_VERSION)
    params = {"wave_overhead_s": theta_o, "inv_hbm_bw": theta_b}
    params.update({f"alpha_{k}": alpha[k] for k in kinds})
    return CalibrationResult(spec=fitted, fitted=True,
                             n_rows=len(fit_rows), n_excluded=n_excl,
                             n_unusable=n_bad, n_duplicates=n_dup,
                             iterations=iterations, params=params)


# ----------------------------------------------------------------------
# persistence
# ----------------------------------------------------------------------

class CalibrationStore:
    """Atomic, *versioned* on-disk store of fitted specs.

    One JSON file per ``(backend cache_key, device_kind)`` under
    ``<root>/calibration/`` — the root of the
    :class:`~repro_torch.tune.store.TuningCache`, so one directory
    holds everything learned about this machine.  Writes go through a
    temp file and ``os.replace``; records carry
    :data:`CALIBRATION_VERSION` and readers skip other versions.

    Each record is a **version chain**: the current fit (monotone
    ``seq``, a ``stale`` flag) plus up to ``_HISTORY_KEEP`` prior fits
    under ``history`` (freshest first).  :meth:`put` supersedes the
    current fit, pushing it into history; :meth:`mark_stale` flags it
    without deleting anything (the drift sentinel does this when the fit
    no longer predicts the card); :meth:`get` returns the **freshest
    non-stale** spec in the chain.  Records without ``seq``/``stale``
    read as ``seq 0, not stale``.
    """

    def __init__(self, root: str | None = None):
        self.root = os.path.join(root or default_cache_root(),
                                 "calibration")
        self._memo: dict[str, CalibratedSpec | None] = {}
        self._lock = threading.Lock()

    def _path(self, backend_key: str, device_kind: str) -> str:
        digest = hashlib.sha256(
            json.dumps([backend_key, device_kind]).encode()
        ).hexdigest()[:24]
        return os.path.join(self.root, digest + ".json")

    def _load(self, path: str) -> dict[str, Any] | None:
        """The raw record at ``path``, or None (missing/torn/foreign)."""
        try:
            with open(path) as f:
                raw = json.load(f)
            if raw.get("version") == CALIBRATION_VERSION:
                return raw
        except (OSError, ValueError, TypeError):
            pass
        return None

    def _write(self, path: str, record: dict[str, Any]) -> None:
        write_json_atomic(self.root, path, json.dumps(record, indent=1))

    @staticmethod
    def _chain(raw: dict[str, Any]) -> list[dict[str, Any]]:
        """Version entries, freshest first: the record then history."""
        chain = [raw]
        hist = raw.get("history")
        if isinstance(hist, list):
            chain.extend(h for h in hist if isinstance(h, dict))
        return chain

    def latest(self, backend_key: str,
               device_kind: str) -> dict[str, Any] | None:
        """The raw current record (with ``seq``/``stale``/``history``),
        or None."""
        return self._load(self._path(backend_key, device_kind))

    def versions(self, backend_key: str,
                 device_kind: str) -> list[dict[str, Any]]:
        """The whole version chain, freshest first (may be empty)."""
        raw = self.latest(backend_key, device_kind)
        return self._chain(raw) if raw is not None else []

    def get(self, backend_key: str,
            device_kind: str) -> CalibratedSpec | None:
        """The freshest **non-stale** fitted spec, or None."""
        path = self._path(backend_key, device_kind)
        with self._lock:
            if path in self._memo:
                return self._memo[path]
        spec: CalibratedSpec | None = None
        raw = self._load(path)
        if raw is not None:
            for entry in self._chain(raw):
                if entry.get("stale"):
                    continue
                try:
                    spec = spec_from_json(entry["spec"])
                except (KeyError, ValueError, TypeError):
                    continue
                break
        with self._lock:
            self._memo[path] = spec
        return spec

    def put(self, backend_key: str, device_kind: str,
            spec: CalibratedSpec, *,
            result: CalibrationResult | None = None) -> str:
        """Persist ``spec`` as the new current version; returns the
        record path.  The previous current version (if any) moves into
        ``history`` with its ``stale`` flag intact."""
        path = self._path(backend_key, device_kind)
        prev = self._load(path)
        seq = 1
        history: list[dict[str, Any]] = []
        if prev is not None:
            seq = int(prev.get("seq", 0)) + 1
            demoted = {k: prev[k] for k in
                       ("seq", "created_at", "spec", "stale", "fit")
                       if k in prev}
            demoted.setdefault("seq", 0)
            demoted.setdefault("stale", False)
            history = ([demoted] + self._chain(prev)[1:])[:_HISTORY_KEEP]
        record: dict[str, Any] = {
            "version": CALIBRATION_VERSION,
            "backend": backend_key,
            "device_kind": device_kind,
            "created_at": time.time(),
            "seq": seq,
            "stale": False,
            "spec": spec_to_json(spec),
        }
        if result is not None:
            record["fit"] = {"n_rows": result.n_rows,
                             "n_excluded": result.n_excluded,
                             "n_unusable": result.n_unusable,
                             "iterations": result.iterations,
                             "params": result.params}
        if history:
            record["history"] = history
        self._write(path, record)
        with self._lock:
            self._memo[path] = spec
        return path

    def mark_stale(self, backend_key: str, device_kind: str) -> bool:
        """Flag the current fit stale (kept on disk, skipped by
        :meth:`get`).  Returns True when a record exists."""
        path = self._path(backend_key, device_kind)
        raw = self._load(path)
        if raw is None or raw.get("stale"):
            return raw is not None
        raw["stale"] = True
        raw["stale_at"] = time.time()
        self._write(path, raw)
        with self._lock:
            self._memo.pop(path, None)
        return True

    def invalidate(self, backend_key: str, device_kind: str) -> None:
        path = self._path(backend_key, device_kind)
        with self._lock:
            self._memo.pop(path, None)
        try:
            os.unlink(path)
        except OSError:
            pass

    def clear(self) -> None:
        with self._lock:
            self._memo.clear()
        remove_json_files(self.root)


# ----------------------------------------------------------------------
# backend-facing entry points
# ----------------------------------------------------------------------

def calibrate_backend(backend, drift=None, *,
                      store: CalibrationStore | None = None,
                      device_kind: str | None = None,
                      persist: bool = True,
                      **fit_kw) -> CalibrationResult:
    """Fit (and by default persist) a calibrated spec for ``backend``.

    ``drift`` follows the :func:`repro_torch.obs.drift.resolve_drift`
    protocol (``None`` -> the default drift log, a path, a
    :class:`~repro_torch.obs.drift.DriftLog`) or may be a plain iterable
    of rows.  The backend's spec (else an H100's) seeds the fit.  On a
    successful fit the spec lands in ``store`` under the
    backend's :meth:`~repro_torch.backends.Backend.cache_key` and the
    device kind (default: the current card's), where
    ``compile_graph(calibrate="auto")`` finds it.
    """
    from repro_torch.backends import resolve
    from repro_torch.obs.drift import resolve_drift
    be = resolve(backend)
    if drift is None or isinstance(drift, (bool, str, DriftLog)):
        log = resolve_drift(True if drift is None else drift)
        rows: Iterable[DriftRow] = log.rows() if log is not None else ()
    else:
        rows = drift
    result = calibrate(rows, spec=be.spec or H100, **fit_kw)
    if result.fitted and persist:
        if device_kind is None:
            device_kind = detect_device_kind()
        (store or CalibrationStore()).put(
            be.cache_key(), device_kind, result.spec, result=result)
    return result


def load_calibration(backend, *, store: CalibrationStore | None = None,
                     device_kind: str | None = None) -> CalibratedSpec | None:
    """The persisted calibrated spec for ``backend`` here, or None."""
    from repro_torch.backends import resolve
    be = resolve(backend)
    if device_kind is None:
        device_kind = detect_device_kind()
    return (store or CalibrationStore()).get(be.cache_key(), device_kind)


def resolve_calibration(backend, calibrate: Any = "auto", *,
                        store: CalibrationStore | None = None,
                        device_kind: str | None = None,
                        drift=None) -> GPUSpec | None:
    """Normalize a user-facing ``calibrate=`` argument into a spec.

    ``None``/``False`` opt out (returns None — the caller keeps the
    seed spec and its cache keys); a
    :class:`~repro_torch.core.vectorize.GPUSpec` instance passes
    through; ``"auto"``/``True`` loads the persisted spec for this
    backend and device kind, fitting one from the drift log first when
    the store is empty but enough rows have accumulated.  Any other
    value raises :class:`TypeError` — silently ignoring a typo'd
    ``calibrate="atuo"`` would serve uncalibrated priors.
    """
    if calibrate is None or calibrate is False:
        return None
    if isinstance(calibrate, GPUSpec):
        return calibrate
    if calibrate is True:
        calibrate = "auto"
    if calibrate != "auto":
        raise TypeError(f"calibrate must be 'auto', True/False/None or a "
                        f"GPUSpec; got {calibrate!r}")
    spec = load_calibration(backend, store=store, device_kind=device_kind)
    if spec is not None:
        return spec
    from repro_torch.obs.drift import resolve_drift
    log = resolve_drift(drift)
    if log is None:
        return None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        result = calibrate_backend(backend, log, store=store,
                                   device_kind=device_kind)
    return result.spec if result.fitted else None
