"""The :class:`Backend` spec: one declarative record per target.

Port of :mod:`repro.backends.spec`.  A ``Backend`` names a target, its
``lower`` hook, the ``measure`` hook the autotuner times candidates
with, and the features it can serve (``capabilities``: ``"tuning"``,
``"replication"``).
The reference's per-backend lane widths and tile caps are not carried
over: every backend of the port lowers every stage kind, and the tile
cap is that of :mod:`repro_torch.core.vectorize`.  ``spec`` is
``None`` for a registered backend (the compiler then models the card it
runs on); a calibrated copy (:meth:`with_spec`) carries its fitted
:class:`~repro_torch.tune.calibrate.CalibratedSpec` and a
:meth:`cache_key` of its own.  Backends are registered once
(:mod:`repro_torch.backends.registry`) and resolved everywhere else; no
other module compares backend names.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable

from repro_torch.core.graph import GraphError

__all__ = ["Backend", "UnsupportedBackendError", "FEATURE_CAPS"]

#: the features a backend may declare
FEATURE_CAPS = frozenset({"tuning", "replication"})


class UnsupportedBackendError(GraphError):
    """A backend cannot serve the request — and says exactly why.

    ``missing`` carries the capability (or requirement) that was
    absent so tooling can react programmatically.
    """

    def __init__(self, message: str, *, backend: str = "",
                 missing: tuple[str, ...] = ()):
        super().__init__(message)
        self.backend = backend
        self.missing = tuple(missing)


@dataclasses.dataclass(frozen=True)
class Backend:
    """Declarative description of one lowering target."""

    name: str
    #: ``lower(group, *, valid_rows) -> fn({channel: tensor})``; it
    #: also takes ``interpret=True`` when a compile asks for the plain
    #: versions
    lower: Callable
    description: str = ""
    #: features this backend serves (a subset of :data:`FEATURE_CAPS`)
    capabilities: frozenset = FEATURE_CAPS
    #: ``measure(graph, backend, config, **kw) -> seconds`` for the
    #: autotuner, with :func:`repro_torch.tune.search.default_measure`'s
    #: keywords (the compiled, built ``app`` among them); ``None`` falls
    #: back to that function
    measure: Callable | None = None
    #: the card's constants for the cost model; ``None`` models the
    #: device the app is compiled for
    spec: Any = None

    def __post_init__(self):
        caps = frozenset(self.capabilities)
        object.__setattr__(self, "capabilities", caps)
        unknown = caps - FEATURE_CAPS
        if unknown:
            raise ValueError(
                f"backend {self.name!r} declares unknown capabilities "
                f"{sorted(unknown)}; known: {sorted(FEATURE_CAPS)}")

    def cache_key(self) -> str:
        """The string compile and tuning caches store for this backend:
        its name, and ``name@digest`` of the constants when it carries
        a spec (a calibrated copy)."""
        if self.spec is None:
            return self.name
        fields = sorted((f, repr(getattr(self.spec, f)))
                        for f in getattr(self.spec, "__dataclass_fields__",
                                         ()))
        blob = json.dumps([type(self.spec).__name__, fields])
        return f"{self.name}@{hashlib.sha256(blob.encode()).hexdigest()[:12]}"

    def with_spec(self, spec: Any) -> "Backend":
        """A copy of this record carrying ``spec`` as its constants.

        The calibration path (:func:`repro_torch.backends.resolve_calibrated`)
        swaps a fitted spec in this way: the copy's :meth:`cache_key`
        reflects the new constants, while the registered record and its
        key are untouched.
        """
        if spec is self.spec:
            return self
        return dataclasses.replace(self, spec=spec)

    def require(self, *caps: str, context: str = "") -> None:
        """Raise :class:`UnsupportedBackendError` naming absent caps."""
        absent = tuple(sorted(set(caps) - self.capabilities))
        if absent:
            where = f" ({context})" if context else ""
            raise UnsupportedBackendError(
                f"backend {self.name!r} does not support "
                f"{', '.join(absent)}{where}; its capabilities are "
                f"{sorted(self.capabilities)}",
                backend=self.name, missing=absent)

    def lower_group(self, group, *,
                    valid_rows: tuple[int, int] | None = None,
                    interpret: bool = False) -> Callable:
        """Hand ``group`` to the lower hook; ``interpret=True`` asks it
        for the group's plain version instead of a kernel."""
        if interpret:
            return self.lower(group, valid_rows=valid_rows, interpret=True)
        return self.lower(group, valid_rows=valid_rows)

    def __repr__(self) -> str:
        return f"Backend({self.name!r})"
