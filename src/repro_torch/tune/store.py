"""The on-disk home of what is learned about this machine.

Port of the two helpers of :mod:`repro.tune.store` that the serving
slice needs: :func:`default_cache_root`, where the drift log lives
(:mod:`repro_torch.obs.drift`), and :func:`detect_device_kind`, the
device label of every OpenMetrics sample the engine exports.  The
persistent tuning cache itself (``ScheduleConfig``, ``TuningKey``,
``TuningRecord``, ``TuningCache``) waits for the tuning slice
(``ROADMAP.md`` A5).
"""
from __future__ import annotations

import os

__all__ = ["default_cache_root", "detect_device_kind"]


def default_cache_root() -> str:
    """Resolve the on-disk root: ``$REPRO_TUNE_CACHE`` else XDG cache.

    The port keeps its own directory (``repro_torch/tune``) beside the
    reference's: its cost model and its measurements are the card's,
    not the TPU's.
    """
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME",
                         os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(xdg, "repro_torch", "tune")


def detect_device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA
    ``device`` (default: the current card), else the device type
    (``"cpu"`` on a host without a card)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return "cpu" if dev.type == "cuda" else dev.type
