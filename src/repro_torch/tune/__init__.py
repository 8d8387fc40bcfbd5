"""Tuning (port of :mod:`repro.tune`).

Only the two helpers the serving slice needs are ported so far:
:func:`~repro_torch.tune.store.default_cache_root` and
:func:`~repro_torch.tune.store.detect_device_kind`.  The measured
search, the persistent tuning cache and calibration come with
``ROADMAP.md`` A5.
"""
from repro_torch.tune.store import default_cache_root, detect_device_kind

__all__ = ["default_cache_root", "detect_device_kind"]
