"""Profile-guided schedule autotuning with a persistent cache (port of
:mod:`repro.tune`).

The analytic cost model (:mod:`repro_torch.core.vectorize`) *ranks*
schedule candidates; this package *measures* the short-list on the card
and persists the winner, so ``compile_graph(..., tune="auto")`` pays for
profiling once per ``(graph, backend, device kind, shapes)`` and then
compiles straight to the measured operating point.

  store.py     — :class:`ScheduleConfig` (a reapplyable point of the
                 search space) and :class:`TuningCache` (atomic on-disk
                 JSON records keyed by :class:`TuningKey`)
  search.py    — :func:`tune_graph` (model-pruned measured search) and
                 :func:`resolve_tuning` (the ``tune=`` argument protocol)
  calibrate.py — :func:`calibrate` (fit the cost model's constants from
                 drift logs), :class:`CalibratedSpec` and its
                 :class:`CalibrationStore` persistence
"""
from repro_torch.tune.calibrate import (CalibratedSpec, CalibrationResult,
                                        CalibrationStore, calibrate,
                                        calibrate_backend, load_calibration,
                                        resolve_calibration)
from repro_torch.tune.search import (Trial, TuningResult, default_measure,
                                     resolve_tuning, tune_graph)
from repro_torch.tune.store import (ScheduleConfig, TuningCache, TuningKey,
                                    TuningRecord, default_cache_root,
                                    detect_device_kind)

__all__ = [
    "ScheduleConfig", "TuningCache", "TuningKey", "TuningRecord",
    "default_cache_root", "detect_device_kind", "Trial", "TuningResult",
    "default_measure", "resolve_tuning", "tune_graph",
    "CalibratedSpec", "CalibrationResult", "CalibrationStore",
    "calibrate", "calibrate_backend", "load_calibration",
    "resolve_calibration",
]
