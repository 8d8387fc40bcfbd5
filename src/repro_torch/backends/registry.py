"""The backend registry: ``register()`` once, ``resolve()`` everywhere.

Port of :mod:`repro.backends.registry` (without the calibration and
LM-kernel hooks, which wait for later slices).
"""
from __future__ import annotations

import threading

from repro_torch.backends.spec import Backend, UnsupportedBackendError

__all__ = ["register", "resolve", "names"]

_lock = threading.Lock()
_registry: dict[str, Backend] = {}


def register(backend: Backend, *, replace: bool = False) -> Backend:
    """Add ``backend``; re-registering a name needs ``replace=True``."""
    if not isinstance(backend, Backend):
        raise TypeError(f"register() takes a Backend, got "
                        f"{type(backend).__name__}")
    with _lock:
        if backend.name in _registry and not replace:
            raise ValueError(f"backend {backend.name!r} is already "
                             f"registered; pass replace=True to substitute it")
        _registry[backend.name] = backend
    return backend


def resolve(backend) -> Backend:
    """A registered name or a ``Backend`` (passed through) -> Backend."""
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        with _lock:
            be = _registry.get(backend)
        if be is not None:
            return be
        raise UnsupportedBackendError(
            f"unknown backend {backend!r}; registered backends: {names()}",
            backend=backend, missing=("registered",))
    raise UnsupportedBackendError(
        f"backend must be a name or a Backend spec, got "
        f"{type(backend).__name__}", missing=("registered",))


def names() -> tuple[str, ...]:
    with _lock:
        return tuple(_registry)
