"""Trace diagnostics: errors that point at the USER'S source line.

Port of :mod:`repro.frontend.diagnostics` (copied as is).

A tracing frontend fails in user code, not in tracer code: when a
traced program mixes shapes, branches on a traced value, or leaks a
Plane into plain Python, the useful location is the line the *user*
wrote — not a traceback through ``tracer.py`` internals.  Every stage
recorded by :mod:`repro_torch.frontend.tracer` therefore captures the first
stack frame *outside* the frontend package at record time
(:func:`user_src`), stores it in ``Stage.meta["src"]``, and every
:class:`TraceError` carries that location in its message.

The error taxonomy mirrors Section IV-A of the paper (what the
extractor can and cannot turn into a dataflow graph):

- :class:`TraceShapeError`   — operand planes disagree on shape
- :class:`TraceDtypeError`   — e.g. arithmetic on a comparison result
- :class:`TraceControlFlowError` — data-dependent Python control flow
  (``if plane:``, ``while plane:``, ``float(plane)``, iteration)
- :class:`TraceLeakError`    — a non-Plane value where a Plane is
  required, or a Plane escaping into NumPy / plain Python
"""
from __future__ import annotations

import os
import sys

from repro_torch.core.graph import GraphError

__all__ = [
    "TraceError",
    "TraceShapeError",
    "TraceDtypeError",
    "TraceControlFlowError",
    "TraceLeakError",
    "user_src",
]

#: directory of the frontend package itself; frames from here are
#: tracer internals, never "user code"
_FRONTEND_DIR = os.path.dirname(os.path.abspath(__file__))


class TraceError(GraphError):
    """Base class for trace-time errors; message ends with the user
    source location (``file.py:line``) when one could be captured."""

    def __init__(self, message: str, src: str | None = None):
        self.src = src
        if src:
            message = f"{message}\n  at {src}"
        super().__init__(message)


class TraceShapeError(TraceError):
    """Operand planes disagree on shape."""


class TraceDtypeError(TraceError):
    """Operand dtypes are unusable for the op (e.g. math on bool)."""


class TraceControlFlowError(TraceError):
    """Python control flow depends on a traced value."""


class TraceLeakError(TraceError):
    """A value crossed the Plane/plain-Python boundary illegally."""


def user_src() -> str | None:
    """``file.py:line`` of the innermost stack frame in USER code.

    Walks outward past every frame that lives inside the frontend
    package; the first frame outside it is the user's call site (for
    the Table-I apps that is a line in ``repro_torch/core/apps.py`` — the
    single-source program itself).  Returns ``None`` when no such
    frame exists (e.g. called from a REPL with no file).
    """
    f = sys._getframe(1)
    while f is not None:
        # co_filename may be non-canonical (e.g. "tests/../src/…")
        # depending on how the package landed on sys.path
        filename = os.path.normpath(os.path.abspath(f.f_code.co_filename))
        if (not filename.startswith(_FRONTEND_DIR)
                and "importlib" not in filename):
            return f"{filename}:{f.f_lineno}"
        f = f.f_back
    return None
