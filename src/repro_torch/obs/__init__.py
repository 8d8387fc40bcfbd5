"""Flight recorder (the subset of :mod:`repro.obs` the compiler uses)."""
from repro_torch.obs.tracer import Tracer, maybe_span, resolve_tracer

__all__ = ["Tracer", "maybe_span", "resolve_tracer"]
