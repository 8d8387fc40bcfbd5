"""The domain-specific library surface (the paper's §III DSL).

Port of :mod:`repro.frontend.ops`: bodies call ``torch.*``, and
:func:`custom` infers output shapes on ``meta`` tensors instead of
``jax.eval_shape``.

These are the operations a single-source program composes — the
AnyHLS-style image-processing library, traced instead of
template-metaprogrammed.  Each call on :class:`~.tracer.Plane`
values records one stage of the matching kind:

====================  =====================================
frontend op           stage kind (``repro_torch.core.graph``)
====================  =====================================
``+ - * /`` etc.      ``point`` / ``pointN``
:func:`conv`          ``stencil`` (taps unrolled, zeros elided)
:func:`window`        ``stencil`` (arbitrary local operator)
:func:`reduce`        ``reduce``  (global, group-breaking)
:func:`where`         ``pointN`` select on a bool Plane
:func:`custom`        ``custom``  (opaque; embeds hand kernels)
====================  =====================================

The unary math family (:data:`sqrt`, :data:`exp`, …) are
:class:`~.tracer.PointFn` objects: on arrays they just compute, on
Planes they record — so the same helper works inside a ``@pointfn``
body and in traced top-level code.

>>> import numpy as np
>>> from repro_torch.frontend import ops as fe
>>> def program(img):
...     blurred = fe.conv(img, np.ones((3, 3), np.float32) / 9.0)
...     return fe.sqrt(abs(img - blurred))
>>> g = fe.trace(program, fe.spec((8, 128)))
>>> len(g.graph_inputs), len(g.graph_outputs)
(1, 1)
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.graph import as_dtype, dtype_name, extract_patches
from repro_torch.frontend.diagnostics import (TraceDtypeError, TraceError,
                                        TraceShapeError, user_src)
from repro_torch.frontend.lib import conv_taps
from repro_torch.frontend.tracer import (InputSpec, Plane, dataflow_fn, pointfn,
                                   trace)

__all__ = [
    "spec", "trace", "dataflow_fn",
    "conv", "window", "reduce", "where", "select", "custom",
    "sqrt", "exp", "log", "abs", "tanh", "sin", "cos", "sign",
    "maximum", "minimum",
]


def spec(shape: Sequence[int], dtype: Any = torch.float32,
         name: str | None = None) -> InputSpec:
    """Declare one traced input: shape, dtype, optional channel name
    (defaults to the traced function's parameter name)."""
    return InputSpec(tuple(int(d) for d in shape), as_dtype(dtype), name)


# ----------------------------------------------------------------------
# stencil ops
# ----------------------------------------------------------------------
def conv(x, taps, *, name: str | None = None, ii: float = 1.0,
         fill: float = 8.0):
    """2-D convolution with a fixed coefficient table.

    ``taps`` is a 2-D array with odd dimensions; the window is its
    shape.  Taps are unrolled into scalar multiplies with zeros elided
    (:func:`repro_torch.frontend.lib.conv_taps`) — the constant folding an
    FPGA synthesizer applies to fixed coefficients.  Edge handling is
    zero-padding, like every stencil in the pipeline.

    On a non-Plane array input this just computes the reference
    convolution (useful for tests and docs).
    """
    taps = np.asarray(taps, np.float32)
    if taps.ndim != 2:
        raise TraceShapeError(
            f"conv taps must be 2-D, got shape {taps.shape}", user_src())
    kh, kw = taps.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise TraceShapeError(
            f"conv taps must have odd dimensions, got {taps.shape}",
            user_src())
    fn = conv_taps(taps)
    if not isinstance(x, Plane):
        return fn(extract_patches(torch.as_tensor(x), (kh, kw)))
    _check_stencil_input("conv", x)
    return x.tracer.record(
        "stencil", [x], fn, key=("conv", taps.tobytes(), taps.shape),
        window=(kh, kw), name=name, ii=ii, fill=fill)


def window(x, win: tuple[int, int], fn: Callable, *,
           name: str | None = None, dtype: Any = None, ii: float = 1.0,
           fill: float = 8.0):
    """Arbitrary local operator over a ``(kh, kw)`` neighborhood.

    ``fn(patches)`` receives the ``kh*kw`` zero-padded shifted views
    stacked on axis 0 (``patches[i]`` is the view for tap ``i`` in
    row-major order) — the line-buffer contract of the ``stencil``
    stage kind.  ``fn`` must use torch ops only (the group kernel records
    them) and must not capture Planes.
    """
    kh, kw = win
    if kh % 2 != 1 or kw % 2 != 1:
        raise TraceShapeError(
            f"window must be odd, got {win}", user_src())
    if isinstance(fn, Plane) or (callable(x) and not isinstance(x, Plane)):
        raise TraceError("window(x, (kh, kw), fn): the plane comes "
                         "first, the local function last", user_src())
    if not isinstance(x, Plane):
        return fn(extract_patches(torch.as_tensor(x), (kh, kw)))
    _check_stencil_input("window", x)
    fn = fn.fn if hasattr(fn, "fn") and callable(fn.fn) else fn
    return x.tracer.record(
        "stencil", [x], fn, key=("window", id(fn)), window=(kh, kw),
        dtype=dtype, name=name, ii=ii, fill=fill)


def _check_stencil_input(op: str, x: Plane) -> None:
    x.tracer.check_alive()
    if x.ndim != 2:
        raise TraceShapeError(
            f"{op} expects a 2-D plane, got shape {x.shape}", user_src())
    if as_dtype(x.dtype) == torch.bool:
        raise TraceDtypeError(
            f"{op} on a bool Plane; convert with fe.where first",
            user_src())


# ----------------------------------------------------------------------
# reductions and opaque stages
# ----------------------------------------------------------------------
def reduce(x, fn: Callable, out_shape: Sequence[int] = (), *,
           dtype: Any = None, name: str | None = None):
    """Global reduction ``fn(x) -> out_shape`` (e.g. ``torch.sum``).

    Reductions break fusion groups — the paper's dataflow pipeline is
    feed-forward, so a global value starts a new kernel.
    """
    if not isinstance(x, Plane):
        return fn(torch.as_tensor(x))
    x.tracer.check_alive()
    return x.tracer.record("reduce", [x], fn,
                           key=("reduce", id(fn), tuple(out_shape)),
                           out_shape=tuple(out_shape), dtype=dtype,
                           name=name)


def custom(fn: Callable, *xs, out_shapes=None, out_dtypes=None,
           name: str | None = None):
    """Opaque whole-array stage (embeds hand-written kernels).

    ``fn(*arrays)`` runs on whole logical arrays; it breaks fusion
    groups.  Output shapes/dtypes are inferred by running ``fn`` on
    ``meta`` tensors (shapes only, no data) unless given.  Returns one Plane when there
    is a single output (inferred or ``len(out_shapes) == 1``), a tuple
    otherwise.
    """
    planes = [x for x in xs if isinstance(x, Plane)]
    if not planes:
        return fn(*xs)
    if len(planes) != len(xs):
        raise TraceError(
            "custom: every array argument must be a Plane; close "
            "constants over fn instead", user_src())
    tracer = planes[0].tracer
    tracer.check_same_trace("custom", *planes)   # shapes may differ
    if out_shapes is None:
        avals = [torch.empty(p.shape, dtype=as_dtype(p.dtype), device="meta")
                 for p in planes]
        out = fn(*avals)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        out_shapes = [tuple(o.shape) for o in outs]
        out_dtypes = [o.dtype for o in outs]
    else:
        single = len(out_shapes) == 1
        out_dtypes = list(out_dtypes or [planes[0].dtype] * len(out_shapes))
    result = tracer.record_custom(planes, fn, out_shapes=out_shapes,
                                  out_dtypes=out_dtypes, name=name)
    return result[0] if single and len(result) == 1 else result


# ----------------------------------------------------------------------
# select
# ----------------------------------------------------------------------
def _where3(c, a, b): return torch.where(c, a, b)          # noqa: E704


def _where_pb(bv):
    def fn(c, a): return torch.where(c, a, bv)             # noqa: E704
    return fn


def _where_pa(av):
    def fn(c, b): return torch.where(c, av, b)             # noqa: E704
    return fn


def _where_ss(av, bv):
    def fn(c): return torch.where(c, av, bv)               # noqa: E704
    return fn


def where(cond, a, b):
    """Elementwise select: ``a`` where ``cond`` else ``b``.

    ``cond`` must be a bool Plane (a comparison result); ``a``/``b``
    may be Planes or scalars.  This is the traced replacement for
    Python ``if`` on data (which raises
    :class:`~repro_torch.frontend.diagnostics.TraceControlFlowError`).
    """
    if not isinstance(cond, Plane):
        return torch.where(torch.as_tensor(cond), a, b)
    tracer = cond.tracer
    tracer.check_alive()
    if as_dtype(cond.dtype) != torch.bool:
        raise TraceDtypeError(
            f"where condition must be a bool Plane (a comparison), got "
            f"dtype {dtype_name(cond.dtype)}", user_src())
    a_p, b_p = isinstance(a, Plane), isinstance(b, Plane)
    if a_p and b_p:
        tracer.check_compatible("where", cond, a, b)
        if as_dtype(a.dtype) == as_dtype(b.dtype):
            dtype = a.dtype
        else:
            dtype = torch.promote_types(as_dtype(a.dtype), as_dtype(b.dtype))
        return tracer.pointn([cond, a, b], _where3, key=("where",),
                             dtype=dtype)
    # scalar branches keep their numeric identity (no float() coercion:
    # fe.where(mask, 1, 0) in an int pipeline stays integral), but are
    # normalized to hashable Python scalars for the CSE memo
    if a_p:
        tracer.check_compatible("where", cond, a)
        b = _where_scalar("b", b)
        return tracer.pointn([cond, a], _where_pb(b),
                             key=("where", "pb", b), dtype=a.dtype)
    if b_p:
        tracer.check_compatible("where", cond, b)
        a = _where_scalar("a", a)
        return tracer.pointn([cond, b], _where_pa(a),
                             key=("where", "pa", a), dtype=b.dtype)
    a, b = _where_scalar("a", a), _where_scalar("b", b)
    return tracer.point(cond, _where_ss(a, b),
                        key=("where", "ss", a, b),
                        dtype=_scalar_pair_dtype(a, b))


def _scalar_pair_dtype(a, b) -> torch.dtype:
    """jnp.result_type of two Python scalars (32-bit defaults)."""
    if isinstance(a, bool) and isinstance(b, bool):
        return torch.bool
    if isinstance(a, float) or isinstance(b, float):
        return torch.float32
    return torch.int32


def _where_scalar(side: str, v):
    """Normalize a where() branch to a hashable Python scalar."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, np.generic) or (isinstance(v, np.ndarray)
                                     and v.ndim == 0):
        return v.item()
    raise TraceError(
        f"where branch {side!r} must be a Plane or a scalar, got "
        f"{type(v).__name__!r}; for array constants close over them in "
        f"a @pointfn or use fe.custom", user_src())


select = where


# ----------------------------------------------------------------------
# torch unary math: compute on tensors, record on Planes
# ----------------------------------------------------------------------
@pointfn
def sqrt(a):
    return torch.sqrt(a)


@pointfn
def exp(a):
    return torch.exp(a)


@pointfn
def log(a):
    return torch.log(a)


@pointfn
def abs(a):                 # noqa: A001 - fe.abs mirrors torch.abs
    return torch.abs(a)


@pointfn
def tanh(a):
    return torch.tanh(a)


@pointfn
def sin(a):
    return torch.sin(a)


@pointfn
def cos(a):
    return torch.cos(a)


@pointfn
def sign(a):
    return torch.sign(a)


def _max2(a, b): return torch.maximum(a, b)              # noqa: E704
def _min2(a, b): return torch.minimum(a, b)              # noqa: E704


def _maxc(c):
    def fn(v): return torch.clamp(v, min=c)              # noqa: E704
    return fn


def _minc(c):
    def fn(v): return torch.clamp(v, max=c)              # noqa: E704
    return fn


def maximum(a, b):
    """Elementwise max of two Planes, or of a Plane and a scalar."""
    return _extremum("maximum", a, b, _max2, _maxc)


def minimum(a, b):
    """Elementwise min of two Planes, or of a Plane and a scalar."""
    return _extremum("minimum", a, b, _min2, _minc)


def _extremum(opname, a, b, pair_fn, const_fac):
    a_p, b_p = isinstance(a, Plane), isinstance(b, Plane)
    if not a_p and not b_p:
        return pair_fn(torch.as_tensor(a), torch.as_tensor(b))
    if a_p and b_p:
        a.tracer.check_compatible(opname, a, b)
        return a.tracer.pointn([a, b], pair_fn, key=(opname,))
    p, c = (a, b) if a_p else (b, a)       # max/min are commutative
    return p.tracer.point(p, const_fac(float(c)),
                          key=(opname, "c", float(c)))
