"""DriftSentinel: the staleness policy that closes the refit loop.

Port of :mod:`repro.obs.sentinel`.  :mod:`repro_torch.tune.calibrate`
*fits* the cost model from drift logs; the sentinel decides **when**:
it watches the accumulating rows and decides that the
:class:`~repro_torch.tune.calibrate.CalibratedSpec` serving
``compile_graph(calibrate="auto")`` no longer predicts this card.

It consumes a rolling window of :class:`~repro_torch.obs.drift.DriftLog`
rows belonging to one backend (rows with a ``backend_key`` attr match
it; rows without one, such as the tuner's trials, match by backend
name) and one device kind, re-scores them under the **active** fit via
:func:`~repro_torch.obs.drift.drift_report`, and flags the fit stale
when any of:

- **correlation decay** — Spearman of re-scored-vs-measured drops
  below ``min_spearman`` (the model misorders workloads again),
- **bias drift** — ``|log10(median measured/modeled)|`` exceeds
  ``max_abs_log10_bias`` (the card got systematically faster or
  slower: a lower power limit, clocks, contention),
- **accumulation** — at least ``refit_rows`` new rows arrived since
  the sentinel's last fit (fresh evidence deserves a fresh fit),
- **no usable fit** — the store holds nothing non-stale for this
  (backend, device kind), which is also how a *device-kind change*
  presents: the store is keyed by device kind, so moving the same
  drift log to a different host makes the active fit vanish rather
  than silently mispredict.

On staleness it marks the superseded record stale in the *versioned*
:class:`~repro_torch.tune.calibrate.CalibrationStore` (kept, not
deleted), runs :func:`~repro_torch.tune.calibrate.calibrate` on the
window, and persists the new fit as the next version — after which
``compile_graph(calibrate="auto")`` resolves the refreshed spec with no
manual step.  :meth:`poll` is the rate-limited entry point the
:class:`~repro_torch.runtime.engine.StreamEngine` calls from its worker
loop; checks and refits are counted in the metrics registry and
emitted as Tracer instants.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np

from repro_torch.obs.drift import (DriftLog, DriftRow, drift_report,
                                   resolve_drift)

__all__ = ["DriftSentinel", "SentinelPolicy"]


@dataclasses.dataclass(frozen=True)
class SentinelPolicy:
    """Staleness thresholds; ``None`` disables a trigger.

    >>> SentinelPolicy(refit_rows=32).refit_rows
    32
    """

    #: re-scored Spearman below this flags correlation decay
    min_spearman: float | None = 0.8
    #: ``|log10 bias|`` of re-scored predictions above this flags drift
    max_abs_log10_bias: float | None = 0.15
    #: this many new rows since the sentinel's last fit forces a refit
    refit_rows: int | None = 64
    #: rolling window: only the newest N matching rows are scored
    window: int = 256
    #: below this many windowed rows the sentinel stays quiet
    min_rows: int = 8
    #: :meth:`DriftSentinel.poll` rate limit (seconds)
    min_interval_s: float = 5.0


class DriftSentinel:
    """Watch one backend's drift window; refit when the fit goes stale.

    ``drift`` follows the :func:`~repro_torch.obs.drift.resolve_drift`
    protocol (log / path / True); ``backend`` anything
    :func:`repro_torch.backends.resolve` accepts.  ``store`` defaults to
    the :class:`~repro_torch.tune.calibrate.CalibrationStore` under the
    default cache root, and ``device_kind`` pins the store key (default:
    detected from ``device``, default the card, and re-detected on every
    check so a device-kind change is noticed).  ``spec`` seeds each
    refit (default the backend's, else an H100's).
    """

    def __init__(self, drift: Any, backend: Any = "cuda_stream", *,
                 store: Any = None, device_kind: str | None = None,
                 policy: SentinelPolicy | None = None,
                 exclude_kinds: tuple[str, ...] = ("compile",),
                 registry: Any = None, tracer: Any = None,
                 device: Any = None, spec: Any = None):
        from repro_torch.backends import resolve
        from repro_torch.tune.calibrate import CalibrationStore
        log = resolve_drift(drift)
        if log is None:
            raise ValueError("DriftSentinel needs a drift log "
                             "(got drift=None/False)")
        self.drift: DriftLog = log
        self.backend = resolve(backend)
        self.backend_key = self.backend.cache_key()
        self.store = store if store is not None else CalibrationStore()
        self.device = device
        self.spec = spec
        self._pinned_kind = device_kind
        self.device_kind = (device_kind if device_kind is not None
                            else self._detect_kind())
        self.policy = policy if policy is not None else SentinelPolicy()
        self.exclude_kinds = tuple(exclude_kinds)
        self.registry = registry
        self.tracer = tracer
        self.checks = 0
        self.refits = 0
        #: row count of the window at the sentinel's last successful fit
        self._rows_at_fit = 0
        self._last_poll_t: float | None = None
        self.last_check: dict[str, Any] | None = None
        self.last_refit: Any = None
        self._lock = threading.Lock()

    def _detect_kind(self) -> str:
        from repro_torch.tune.store import detect_device_kind
        return detect_device_kind(self.device)

    # -- the window ----------------------------------------------------
    def _matches(self, r: DriftRow) -> bool:
        key = r.attrs.get("backend_key")
        if key is not None:
            return key == self.backend_key
        return r.backend == self.backend.name   # rows without a key

    def window_rows(self) -> list[DriftRow]:
        """The newest ``policy.window`` usable rows for this backend."""
        rows = [r for r in self.drift.rows()
                if self._matches(r) and r.kind not in self.exclude_kinds
                and np.isfinite(r.measured_s) and r.measured_s > 0]
        return rows[-self.policy.window:]

    # -- staleness check -----------------------------------------------
    def check(self, now: float | None = None) -> dict[str, Any]:
        """Score the window against the active fit; list stale reasons.

        Returns ``{"stale", "reasons", "n_rows", "n_new", "active_seq",
        "spearman", "log10_bias", "device_kind", "report"}``.  A short
        window (< ``policy.min_rows``) is never stale — the sentinel
        refuses to act on noise.
        """
        t = now if now is not None else time.time()
        pol = self.policy
        with self._lock:
            self.checks += 1
            if self._pinned_kind is None:
                kind = self._detect_kind()
                if kind != self.device_kind:
                    self.device_kind = kind
            rows = self.window_rows()
            n = len(rows)
            n_new = n - self._rows_at_fit
            active_raw = self.store.latest(self.backend_key,
                                           self.device_kind)
            active = self.store.get(self.backend_key, self.device_kind)
            reasons: list[str] = []
            spear = bias = None
            report: dict[str, Any] = {}
            if n >= pol.min_rows:
                report = drift_report(rows, spec=active)
                stats = report["with_spec"] if active is not None else report
                spear = stats.get("spearman")
                bias = stats.get("log10_bias")
                if active is None:
                    reasons.append("uncalibrated")
                else:
                    if (pol.min_spearman is not None and spear is not None
                            and np.isfinite(spear)
                            and spear < pol.min_spearman):
                        reasons.append("spearman")
                    if (pol.max_abs_log10_bias is not None
                            and bias is not None and np.isfinite(bias)
                            and abs(bias) > pol.max_abs_log10_bias):
                        reasons.append("bias")
                    if (pol.refit_rows is not None
                            and n_new >= pol.refit_rows):
                        reasons.append("new_rows")
            out = {
                "stale": bool(reasons), "reasons": reasons,
                "n_rows": n, "n_new": n_new,
                "active_seq": (active_raw or {}).get("seq"),
                "spearman": spear, "log10_bias": bias,
                "device_kind": self.device_kind,
                "report": report,
            }
            self.last_check = out
        reg = self.registry
        if reg is not None:
            reg.counter("sentinel_checks").inc()
            if reasons:
                reg.counter("sentinel_stale").inc()
            reg.gauge("sentinel_rows").set(float(n))
            if spear is not None and np.isfinite(spear):
                reg.gauge("sentinel_spearman").set(float(spear))
            if bias is not None and np.isfinite(bias):
                reg.gauge("sentinel_log10_bias").set(float(bias))
        if reasons and self.tracer is not None:
            self.tracer.instant("sentinel.stale", cat="sentinel", ts=t,
                                reasons=",".join(reasons), rows=n)
        return out

    # -- refit ---------------------------------------------------------
    def refit(self, reasons: tuple[str, ...] = ()) -> Any:
        """Mark the decayed fit stale, fit the window, persist a new
        version.  Returns the :class:`CalibrationResult` (``fitted``
        False means the window could not identify the constants — the
        stale mark still protects ``calibrate="auto"`` from the bad
        fit)."""
        from repro_torch.core.vectorize import H100
        from repro_torch.tune.calibrate import calibrate
        with self._lock:
            rows = self.window_rows()
            if {"spearman", "bias"} & set(reasons):
                # the active fit demonstrably mispredicts: retire it
                # even if the refit below falls back
                self.store.mark_stale(self.backend_key, self.device_kind)
            result = calibrate(rows, spec=self.spec or self.backend.spec
                               or H100,
                               min_rows=self.policy.min_rows,
                               exclude_kinds=self.exclude_kinds)
            if result.fitted:
                self.store.put(self.backend_key, self.device_kind,
                               result.spec, result=result)
                self._rows_at_fit = len(rows)
                self.refits += 1
            self.last_refit = result
        reg = self.registry
        if reg is not None:
            reg.counter("sentinel_refits" if result.fitted
                        else "sentinel_refit_failures").inc()
        if self.tracer is not None:
            self.tracer.instant("sentinel.refit", cat="sentinel",
                                fitted=result.fitted,
                                rows=result.n_rows,
                                reasons=",".join(reasons))
        return result

    def poll(self, now: float | None = None) -> dict[str, Any] | None:
        """Rate-limited check-and-refit for a worker loop.

        Returns the check dict (with ``refit`` attached when one ran),
        or ``None`` when called again inside ``min_interval_s``.
        """
        t = now if now is not None else time.time()
        with self._lock:
            last = self._last_poll_t
            if last is not None and (t - last) < self.policy.min_interval_s:
                return None
            self._last_poll_t = t
        out = self.check(now=t)
        if out["stale"]:
            result = self.refit(tuple(out["reasons"]))
            out["refit"] = {"fitted": result.fitted,
                            "n_rows": result.n_rows,
                            "warning": result.warning}
        return out
