"""Single-source tracing frontend (port of :mod:`repro.frontend`).

Write an ordinary Python function over planes; the frontend extracts
the dataflow graph and the compiler lowers it::

    import repro_torch.frontend as fe
    from repro_torch.frontend.lib import GAUSS3

    @fe.dataflow_fn                      # cuda_stream on the card
    def sharpen(img):
        blur = fe.conv(img, GAUSS3)
        return 2.0 * img - blur

    out = sharpen(frame)                 # trace + compile + run, memoized
"""
from repro_torch.frontend.diagnostics import (TraceControlFlowError,
                                              TraceDtypeError, TraceError,
                                              TraceLeakError, TraceShapeError)
from repro_torch.frontend.tracer import (DataflowFunction, InputSpec, Plane,
                                         PointFn, dataflow_fn, pointfn, trace)
from repro_torch.frontend.ops import (abs, conv, cos, custom, exp, log,
                                      maximum, minimum, reduce, select, sign,
                                      sin, spec, sqrt, tanh, where, window)
from repro_torch.frontend import lib

__all__ = [
    "Plane", "InputSpec", "PointFn", "pointfn", "trace", "dataflow_fn",
    "DataflowFunction", "spec",
    "conv", "window", "reduce", "where", "select", "custom",
    "sqrt", "exp", "log", "abs", "tanh", "sin", "cos", "sign",
    "maximum", "minimum", "lib",
    "TraceError", "TraceShapeError", "TraceDtypeError",
    "TraceControlFlowError", "TraceLeakError",
]
