"""The :class:`Backend` spec: one declarative record per target.

Port of :mod:`repro.backends.spec`.  A ``Backend`` names a target and
its ``lower`` hook.  The reference's per-backend capability sets, tile
caps and device specs are not carried over: every backend of the port
lowers every stage kind, and the tile cap and the card's constants are
those of :mod:`repro_torch.core.vectorize`.  Backends are registered
once (:mod:`repro_torch.backends.registry`) and resolved everywhere
else; no other module compares backend names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.graph import GraphError

__all__ = ["Backend", "UnsupportedBackendError"]


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
    #: ``lower(group, *, valid_rows) -> fn({channel: tensor})``
    lower: Callable
    description: str = ""

    def cache_key(self) -> str:
        return self.name

    def lower_group(self, group, *,
                    valid_rows: tuple[int, int] | None = None) -> Callable:
        """Hand ``group`` to the lower hook."""
        return self.lower(group, valid_rows=valid_rows)

    def __repr__(self) -> str:
        return f"Backend({self.name!r})"
