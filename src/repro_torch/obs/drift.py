"""Modeled-vs-measured drift capture: the cost model's report card.

Port of :mod:`repro.obs.drift`.  The log, the rows and the report are
copies; :func:`predict_features` rebuilds the port's cost model
(:func:`repro_torch.core.vectorize.modeled_plane_time`), not the TPU's.

The analytic cost model
(:func:`repro_torch.core.vectorize.modeled_schedule_time`) picks every
group's tile from data-sheet constants.  Calibrating them needs data:
a persistent stream of (modeled, measured) pairs from real runs.

:class:`DriftLog` is that stream — an append-only JSONL file under
:func:`~repro_torch.tune.store.default_cache_root` (one directory for
everything learned about this machine).  The serving engine appends a
row for **every batched launch** (kind ``launch``), the autotuner one
for **every measured candidate** (kind ``trial``), and the engine one
for the **first launch of each (signature, width)** bucket (kind
``compile``, where the measured time includes building the kernels).

:func:`drift_report` turns the accumulated rows into the calibration
input: per-group and overall **Spearman rank correlation** (does the
model at least order configurations correctly?) and **bias** (the
median measured/modeled ratio — the constant the model is off by).
Spearman is computed manually (tie-averaged ranks + Pearson on the
ranks), without scipy.

Rows may additionally carry **features** (``attrs["features"]``, see
:func:`repro_torch.core.vectorize.schedule_features`): the terms
(blocks, bytes and per-kind operations a block, fill, waves) behind the
modeled seconds — what the calibration fit
(:func:`repro_torch.tune.calibrate.calibrate`) regresses.  :func:`predict_features` reconstitutes the modeled time from
those features under a spec's rates, and ``drift_report(rows,
spec=...)`` shows the comparison under it without re-running anything.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterable

import numpy as np

__all__ = ["DriftLog", "DriftRow", "default_drift_path", "resolve_drift",
           "spearman", "drift_report", "predict_features", "group_seconds",
           "DRIFT_ENV"]

#: environment variable overriding the on-disk drift log location
DRIFT_ENV = "REPRO_DRIFT_LOG"

#: rows buffered in memory before an automatic flush to disk
_FLUSH_EVERY = 64


def default_drift_path() -> str:
    """``drift.jsonl`` beside the tuning cache (``$REPRO_DRIFT_LOG``
    overrides)."""
    env = os.environ.get(DRIFT_ENV, "").strip()
    if env:
        return env
    # lazy import: obs must stay importable without pulling in the
    # tune -> core import chain at module load
    from repro_torch.tune.store import default_cache_root
    return os.path.join(default_cache_root(), "drift.jsonl")


class DriftRow:
    """One (modeled, measured) observation.

    ``modeled_s`` / ``measured_s`` are wall-clock seconds for the same
    unit of work; ``kind`` says where the pair came from (``launch``,
    ``compile``, ``trial``); ``signature`` + ``shapes`` + ``backend``
    identify the workload so reports can group rows that the model
    should at least rank consistently.
    """

    __slots__ = ("kind", "signature", "shapes", "backend", "modeled_s",
                 "measured_s", "attrs")

    def __init__(self, kind: str, signature: str, shapes: Any,
                 backend: str, modeled_s: float, measured_s: float,
                 attrs: dict[str, Any] | None = None):
        self.kind = kind
        self.signature = signature
        self.shapes = shapes
        self.backend = backend
        self.modeled_s = float(modeled_s)
        self.measured_s = float(measured_s)
        self.attrs = attrs or {}

    def as_dict(self) -> dict[str, Any]:
        d = {"kind": self.kind, "signature": self.signature,
             "shapes": self.shapes, "backend": self.backend,
             "modeled_s": self.modeled_s, "measured_s": self.measured_s}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DriftRow":
        return cls(d.get("kind", "launch"), d.get("signature", ""),
                   d.get("shapes"), d.get("backend", ""),
                   d.get("modeled_s", 0.0), d.get("measured_s", 0.0),
                   d.get("attrs"))

    @property
    def features(self) -> dict[str, Any] | None:
        """Cost-model features behind ``modeled_s`` (or None for rows
        whose writer does not model)."""
        f = self.attrs.get("features")
        return f if isinstance(f, dict) else None


class DriftLog:
    """Append-only JSONL log of drift rows (thread-safe, buffered).

    ``record`` costs a dict build and a list append; rows hit disk
    every ``_FLUSH_EVERY`` records, on :meth:`flush`, and at
    interpreter exit — the serving hot path never waits on a write.
    A missing parent directory is created on first flush.

    ``max_rows`` bounds on-disk growth under long-running serving:
    when a flush pushes the live file past the cap it **rotates** —
    the live file replaces ``<path>.1`` (whose previous contents
    disappear from visibility and are counted in
    :attr:`rotated_rows`) and a fresh live file starts.
    :meth:`rows` and :func:`drift_report` read
    ``<path>.1`` *then* the live file, so at most ``2 * max_rows``
    recent rows stay visible and rotation never yanks history out
    from under a rolling window mid-scan.  ``max_rows=None`` (the
    default) keeps the pre-rotation unbounded behaviour.
    """

    def __init__(self, path: str | None = None, *,
                 max_rows: int | None = None):
        if max_rows is not None and max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.path = path if path is not None else default_drift_path()
        self.max_rows = max_rows
        #: rows retired from visibility by rotation (process lifetime)
        self.rotated_rows = 0
        self._disk_rows: int | None = None    # live-file rows, lazy count
        self._buf: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        import atexit
        atexit.register(self.flush)

    @property
    def rotated_path(self) -> str:
        """Where the previous generation lives after a rotation."""
        return self.path + ".1"

    def record(self, kind: str, signature: str, shapes: Any,
               backend: str, modeled_s: float, measured_s: float,
               **attrs: Any) -> None:
        row = DriftRow(kind, signature, shapes, backend, modeled_s,
                       measured_s, attrs or None)
        with self._lock:
            self._buf.append(row.as_dict())
            need_flush = len(self._buf) >= _FLUSH_EVERY
        if need_flush:
            self.flush()

    @staticmethod
    def _count_lines(path: str) -> int:
        try:
            with open(path) as f:
                return sum(1 for line in f if line.strip())
        except OSError:
            return 0

    def flush(self) -> None:
        with self._lock:
            if not self._buf:
                return
            rows, self._buf = self._buf, []
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with self._lock:
            if self._disk_rows is None:
                self._disk_rows = self._count_lines(self.path)
            with open(self.path, "a") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
            self._disk_rows += len(rows)
            if (self.max_rows is not None
                    and self._disk_rows > self.max_rows):
                retiring = self._count_lines(self.rotated_path)
                try:
                    os.replace(self.path, self.rotated_path)
                except OSError:
                    return             # rotation is best-effort
                self.rotated_rows += retiring
                self._disk_rows = 0

    @staticmethod
    def _read_rows(path: str, out: list[DriftRow]) -> None:
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(DriftRow.from_dict(json.loads(line)))
                except (json.JSONDecodeError, TypeError):
                    continue           # torn write: skip, keep reading

    def rows(self) -> list[DriftRow]:
        """All visible rows, oldest first: the rotated generation (if
        any), then the live file, then the unflushed buffer."""
        out: list[DriftRow] = []
        self._read_rows(self.rotated_path, out)
        self._read_rows(self.path, out)
        with self._lock:
            out.extend(DriftRow.from_dict(d) for d in self._buf)
        return out

    def __len__(self) -> int:
        n = self._count_lines(self.rotated_path) + self._count_lines(self.path)
        with self._lock:
            return n + len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._disk_rows = 0
        for path in (self.path, self.rotated_path):
            if os.path.exists(path):
                os.remove(path)


def resolve_drift(drift: Any) -> DriftLog | None:
    """Normalize a user-facing ``drift=`` argument into a log.

    ``None`` enables drift capture only when ``$REPRO_DRIFT_LOG`` is
    set (off-by-default: no disk writes unless asked); ``True`` logs
    to :func:`default_drift_path`; a path string logs there; ``False``
    opts out even under the env var; a :class:`DriftLog` passes
    through.
    """
    if drift is None:
        if not os.environ.get(DRIFT_ENV, "").strip():
            return None
        return DriftLog()
    if drift is True:
        return DriftLog()
    if drift is False:
        return None
    if isinstance(drift, str):
        return DriftLog(drift)
    if not isinstance(drift, DriftLog):
        raise TypeError(f"drift must be a DriftLog, path, True/False or "
                        f"None; got {type(drift).__name__}")
    return drift


def _ranks(xs: np.ndarray) -> np.ndarray:
    """Tie-averaged ranks (1-based, fractional on ties)."""
    order = np.argsort(xs, kind="stable")
    ranks = np.empty(len(xs), dtype=np.float64)
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(xs: Iterable[float], ys: Iterable[float]) -> float:
    """Spearman rank correlation of two sequences (nan if degenerate).

    >>> round(spearman([1, 2, 3, 4], [10, 20, 30, 40]), 3)
    1.0
    >>> round(spearman([1, 2, 3, 4], [40, 30, 20, 10]), 3)
    -1.0
    """
    x = np.asarray(list(xs), dtype=np.float64)
    y = np.asarray(list(ys), dtype=np.float64)
    if len(x) != len(y):
        raise ValueError(f"length mismatch: {len(x)} vs {len(y)}")
    if len(x) < 2:
        return float("nan")
    rx, ry = _ranks(x), _ranks(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return float("nan")
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))


def _ops(ops_block: Any, spec: Any) -> float:
    """One block's stage operations priced under ``spec``: per stage
    kind, times the kind's ``ii_scale`` multiplier (a calibrated spec's;
    1.0 for any other).  A scalar ``ops_block`` (rows written before the
    operations were split by kind) is taken as it is."""
    if not isinstance(ops_block, dict):
        return ops_block
    scale = dict(getattr(spec, "ii_scale", ()) or ())
    return sum(v * scale.get(k, 1.0) for k, v in sorted(ops_block.items()))


def group_seconds(g: dict[str, Any], spec: Any) -> float:
    """Modeled seconds of one fusion group from its features (one entry
    of ``features["groups"]``); the single formula behind both
    :func:`predict_features` and
    :func:`repro_torch.core.vectorize.modeled_plane_time`."""
    dma_s = g["blocks"] * g["bytes_block"] / (spec.hbm_bw * g["fill"])
    compute_s = (g["blocks"] * _ops(g["ops_block"], spec)
                 / (spec.fp32_flops * g["fill"]))
    return max(dma_s, compute_s) + g["waves"] * spec.wave_overhead_s


def predict_features(features: dict[str, Any], spec: Any) -> float:
    """Modeled seconds reconstituted from drift-row features.

    ``features`` is the dict produced by
    :func:`repro_torch.core.vectorize.schedule_features` (or
    :func:`~repro_torch.core.vectorize.plane_features` wrapped in a
    single-group list): per fusion group the ``blocks`` of its grid,
    the device-memory ``bytes_block`` and the stage operations
    ``ops_block`` of one block (per stage kind), and the ``fill`` and
    ``waves`` of the grid on the card.  The prediction is, per group,

    ``max(blocks * bytes_block / (hbm_bw * fill),
    blocks * sum_kind(ops_block[kind] * ii_scale[kind])
    / (fp32_flops * fill)) + waves * wave_overhead_s``

    summed over groups and multiplied by ``items`` — **bit-identical**
    to :func:`repro_torch.core.vectorize.modeled_schedule_time` under
    the spec the features were taken with.  ``ii_scale`` is a
    calibrated spec's per-kind multiplier (1.0 without one).  A scalar
    ``ops_block`` (rows written before the split by kind) is priced
    unscaled.  ``spec`` is duck typed (``hbm_bw``, ``fp32_flops``,
    ``wave_overhead_s`` and an optional ``ii_scale`` are read), keeping
    :mod:`repro_torch.obs` free of the core import chain.

    >>> class S:
    ...     hbm_bw, fp32_flops, wave_overhead_s = 1e9, 1e9, 1e-6
    >>> feats = {"groups": [{"blocks": 4, "bytes_block": 1000,
    ...                      "ops_block": {"point": 500.0}, "fill": 0.5,
    ...                      "waves": 1}]}
    >>> round(predict_features(feats, S()) * 1e6, 3)  # 4*1000/0.5e9 + 1us
    9.0
    """
    total = 0.0
    for g in features.get("groups", ()):
        total += group_seconds(g, spec)
    return total * features.get("items", 1)


def _usable(modeled: float, measured: float) -> bool:
    """A (modeled, measured) pair the stats can digest: finite and
    positive on both sides.  NaN/inf measurements (a hung launch, a
    clock that wrapped) and unmodeled rows are skipped — and counted,
    so a report can't silently hide a sick log."""
    return (np.isfinite(modeled) and np.isfinite(measured)
            and modeled > 0 and measured > 0)


def _summary(modeled: np.ndarray, measured: np.ndarray) -> dict[str, Any]:
    ratio = measured / modeled
    q75, q25 = np.percentile(np.log10(ratio), [75, 25])
    return {
        "n": int(len(modeled)),
        "spearman": spearman(modeled, measured),
        "bias": float(np.median(ratio)),
        "log10_bias": float(np.median(np.log10(ratio))),
        "log10_spread": float(q75 - q25),
    }


def drift_report(rows: Iterable[DriftRow] | DriftLog | None = None,
                 *, min_group: int = 2, spec: Any = None) -> dict[str, Any]:
    """Summarize accumulated drift rows into the calibration inputs.

    Returns::

        {"n": ..., "skipped": ...,         # usable rows / dropped rows
         "spearman": ...,                  # overall rank correlation
         "bias": ...,                      # median measured/modeled
         "log10_bias": ..., "log10_spread": ...,
         "groups": {sig: {"n", "spearman", "bias"}, ...},
         "by_kind": {kind: n, ...},
         "with_spec": {...}}               # only when ``spec=`` given

    ``spearman`` near 1 means the model orders workloads correctly
    even if its absolute scale is off (then ``bias`` is the single
    constant to fold in); near 0 or negative means the model misorders
    them, and picking tiles by the model is unreliable.  Rows whose modeled or measured seconds are NaN, infinite or
    nonpositive (a hung launch, an unmodeled path) are skipped and
    counted in ``skipped`` rather than poisoning every statistic.
    Groups smaller than ``min_group`` are skipped for per-group
    correlation but still count toward the overall stats.

    ``spec=`` turns on the before/after-fit comparison: every usable
    row carrying features is re-scored with :func:`predict_features`
    under the given (typically calibrated) spec, and the same summary
    statistics over those re-predictions land under ``with_spec`` —
    plus ``without_features``, the count of rows that predate feature
    capture and so cannot be re-scored.  Comparing the top-level
    ``spearman``/``bias`` (as logged, under the spec that produced the
    rows) against ``with_spec`` is the calibration exit criterion.
    """
    if rows is None:
        rows = DriftLog()
    if isinstance(rows, DriftLog):
        rows = rows.rows()
    rows = list(rows)
    usable = [r for r in rows if _usable(r.modeled_s, r.measured_s)]
    skipped = len(rows) - len(usable)
    if not usable:
        out: dict[str, Any] = {
            "n": 0, "skipped": skipped, "spearman": float("nan"),
            "bias": float("nan"), "log10_bias": float("nan"),
            "log10_spread": float("nan"), "groups": {}, "by_kind": {}}
        if spec is not None:
            out["with_spec"] = {
                "n": 0, "without_features": 0, "spearman": float("nan"),
                "bias": float("nan"), "log10_bias": float("nan"),
                "log10_spread": float("nan")}
        return out
    modeled = np.asarray([r.modeled_s for r in usable])
    measured = np.asarray([r.measured_s for r in usable])
    by_kind: dict[str, int] = {}
    groups: dict[str, list[DriftRow]] = {}
    for r in usable:
        by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
        groups.setdefault(r.signature, []).append(r)
    group_stats: dict[str, dict[str, Any]] = {}
    for sig, rs in sorted(groups.items()):
        if len(rs) < min_group:
            continue
        g_mod = [r.modeled_s for r in rs]
        g_meas = [r.measured_s for r in rs]
        group_stats[sig] = {
            "n": len(rs),
            "spearman": spearman(g_mod, g_meas),
            "bias": float(np.median(np.asarray(g_meas)
                                    / np.asarray(g_mod))),
        }
    out = _summary(modeled, measured)
    out["skipped"] = skipped
    out["groups"] = group_stats
    out["by_kind"] = by_kind
    if spec is not None:
        re_mod: list[float] = []
        re_meas: list[float] = []
        no_feats = 0
        for r in usable:
            feats = r.features
            pred = (predict_features(feats, spec)
                    if feats is not None else float("nan"))
            if _usable(pred, r.measured_s):
                re_mod.append(pred)
                re_meas.append(r.measured_s)
            else:
                no_feats += 1
        if re_mod:
            with_spec = _summary(np.asarray(re_mod), np.asarray(re_meas))
        else:
            with_spec = {"n": 0, "spearman": float("nan"),
                         "bias": float("nan"), "log10_bias": float("nan"),
                         "log10_spread": float("nan")}
        with_spec["without_features"] = no_feats
        out["with_spec"] = with_spec
    return out
