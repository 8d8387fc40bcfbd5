"""Device resolution shared by every entry point of the port.

Entry points default to the card.  A request for ``"cuda"`` on a host
without one raises :class:`DeviceUnavailableError`: the port never
silently runs a CUDA request on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["DeviceUnavailableError", "NotPortedError", "resolve_device"]


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this host."""


class NotPortedError(NotImplementedError):
    """An input of :mod:`repro` that the port does not take.  Only one is
    left: a 64-bit plane for ``stream_pipeline``, which the reference too
    runs only as float32 (JAX's default ``jax_enable_x64=False`` turns it
    into float32 before the kernel).  The message says which."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist, else raise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available()"
            f" is False on this host; pass device='cpu' to run the plain "
            f"PyTorch versions on the CPU")
    return dev
