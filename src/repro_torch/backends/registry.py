"""The backend registry: ``register()`` once, ``resolve()`` everywhere.

Port of :mod:`repro.backends.registry` (without the LM-kernel hook,
which waits for a later slice).
"""
from __future__ import annotations

import threading

from repro_torch.backends.spec import Backend, UnsupportedBackendError

__all__ = ["register", "resolve", "resolve_calibrated", "names"]

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


def resolve_calibrated(backend, calibrate="auto", **kwargs) -> Backend:
    """Resolve ``backend``, swapping in its calibrated spec if one applies.

    ``calibrate=None``/``False`` (or no persisted or fittable
    calibration for this backend and device kind) returns the resolved
    record *unchanged* — same object, same :meth:`~Backend.cache_key`.
    A hit returns a copy (:meth:`~Backend.with_spec`) whose key covers
    the fitted constants, so calibrated compiles and tunings get their
    own cache entries.  ``kwargs`` pass through to
    :func:`repro_torch.tune.calibrate.resolve_calibration` (``store=``,
    ``device_kind=``, ``drift=``).
    """
    be = resolve(backend)
    if calibrate is None or calibrate is False:
        return be
    # lazy import: backends must stay importable without the tune
    # package (which imports core, which imports backends)
    from repro_torch.tune.calibrate import resolve_calibration
    spec = resolve_calibration(be, calibrate, **kwargs)
    if spec is None or spec is be.spec:
        return be
    return be.with_spec(spec)


def names() -> tuple[str, ...]:
    with _lock:
        return tuple(_registry)
