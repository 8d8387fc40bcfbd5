"""Tracing machinery: run plain array code, record a dataflow graph.

Port of :mod:`repro_torch.frontend.tracer`: channel dtypes are torch dtypes
and the dtype rules (``_promote`` and the weak-scalar rule) follow
jnp's on them.

This is the paper's *graph extraction from a single-source program*
(Section IV-A) as an operator-overloading tracer.  The user writes an
ordinary Python function over :class:`Plane` values; every arithmetic
operator and every library call (:mod:`repro_torch.frontend.ops`) records
one ``point`` / ``pointN`` / ``stencil`` / ``reduce`` / ``custom``
stage into a :class:`~repro_torch.core.graph.DataflowGraph`.  Fan-out is
implicit — reading a Plane twice simply leaves a multi-reader channel
for the existing ``AutoSplitInsertion`` pass to make explicit.

Trace-time canonicalization:

- **CSE** — structurally identical records (same op, same operand
  channels, same constants) return the *same* Plane, so a reused
  subexpression becomes one stage with fan-out, not two stages.
- **constant folding** — scalar-only subtrees fold in plain Python
  before they ever reach a Plane, and algebraic identities
  (``x * 1``, ``x + 0``, ``x / 1``, ``x ** 1``) record nothing.
- **coalescing** — chains of recorded point ops are left for the
  ``PointFusion`` pass, which :func:`trace` runs before returning, so
  a traced graph comes back fully canonical (``validate()``-clean,
  ``reference_eval``-ready).

Stage functions are drawn from the module-level op library below
(``add``, ``sub``, ``scale(c)``, …) so that traced graphs have
*stable structural fingerprints*: two traces of the same program —
even across processes — produce the same
:meth:`~repro_torch.core.graph.DataflowGraph.signature`, which is what the
compile cache and the persistent tuning cache key on.

>>> import numpy as np
>>> from repro_torch.frontend.tracer import trace
>>> def program(img):
...     return 2.0 * img + 1.0
>>> g = trace(program, (8, 128))
>>> [c.name for c in g.graph_inputs], [c.name for c in g.graph_outputs]
(['img'], ['out'])
>>> x = np.ones((8, 128), np.float32)
>>> float(g.reference_eval({"img": x})["out"][0, 0])
3.0
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import numbers
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.graph import Channel, DataflowGraph, as_dtype, dtype_name
from repro_torch.core.transform import default_pipeline
from repro_torch.frontend.diagnostics import (TraceControlFlowError, TraceDtypeError,
                                        TraceError, TraceLeakError,
                                        TraceShapeError, user_src)

__all__ = [
    "Plane", "InputSpec", "trace", "dataflow_fn", "DataflowFunction",
    "PointFn", "pointfn",
    # canonical elementwise op library (stable fingerprints)
    "add", "sub", "mul", "div", "square", "neg",
    "offset", "scale", "subc", "rsub", "divc", "rdiv", "powc",
]


# ----------------------------------------------------------------------
# canonical elementwise ops: every traced operator maps onto exactly one
# of these, so structurally equal programs yield equal stage
# fingerprints (see graph._fn_fingerprint).
# ----------------------------------------------------------------------
def add(a, b): return a + b            # noqa: E704
def sub(a, b): return a - b            # noqa: E704
def mul(a, b): return a * b            # noqa: E704
def div(a, b): return a / b            # noqa: E704
def square(a): return a * a            # noqa: E704
def neg(a): return -a                  # noqa: E704
def _pow2(a, b): return a ** b         # noqa: E704


def offset(c):
    """``v + c`` with the scalar folded into the stage (exact closure)."""
    def fn(v): return v + c            # noqa: E704
    return fn


def scale(c):
    """``v * c`` — the paper's constant-coefficient multiply."""
    def fn(v): return v * c            # noqa: E704
    return fn


def subc(c):
    def fn(v): return v - c            # noqa: E704
    return fn


def rsub(c):
    def fn(v): return c - v            # noqa: E704
    return fn


def divc(c):
    def fn(v): return v / c            # noqa: E704
    return fn


def rdiv(c):
    def fn(v): return c / v            # noqa: E704
    return fn


def powc(c):
    def fn(v): return v ** c           # noqa: E704
    return fn


def rpowc(c):
    def fn(v): return c ** v           # noqa: E704
    return fn


def _lt(a, b): return a < b            # noqa: E704
def _le(a, b): return a <= b           # noqa: E704
def _gt(a, b): return a > b            # noqa: E704
def _ge(a, b): return a >= b           # noqa: E704
def _eq(a, b): return a == b           # noqa: E704
def _ne(a, b): return a != b           # noqa: E704


def _cmpc(op: str, c):
    if op == "lt":
        def fn(v): return v < c        # noqa: E704
    elif op == "le":
        def fn(v): return v <= c       # noqa: E704
    elif op == "gt":
        def fn(v): return v > c        # noqa: E704
    elif op == "ge":
        def fn(v): return v >= c       # noqa: E704
    elif op == "eq":
        def fn(v): return v == c       # noqa: E704
    else:
        def fn(v): return v != c       # noqa: E704
    return fn


def _and(a, b): return a & b           # noqa: E704
def _or(a, b): return a | b            # noqa: E704
def _xor(a, b): return a ^ b           # noqa: E704
def _invert(a): return ~a              # noqa: E704
def _identity(a): return a             # noqa: E704


# ----------------------------------------------------------------------
# Plane: the traced value
# ----------------------------------------------------------------------
class Plane:
    """A traced array value (the paper's *virtual image*).

    Planes are produced by :func:`trace` (one per graph input) and by
    every frontend op; each arithmetic operator on a Plane records a
    ``point``/``pointN`` stage.  Planes are symbolic — they have a
    shape and dtype but no data, so anything that would need a
    concrete value (``if plane:``, ``float(plane)``, ``np.asarray``)
    raises a :class:`~repro_torch.frontend.diagnostics.TraceError` pointing
    at the offending user source line.
    """

    #: defeat NumPy's elementwise dispatch so ``ndarray <op> Plane``
    #: reaches our reflected operators (and fails loudly there)
    __array_priority__ = 1000
    __array_ufunc__ = None
    __slots__ = ("tracer", "channel")

    def __init__(self, tracer: "_Tracer", channel: Channel):
        self.tracer = tracer
        self.channel = channel

    # -- metadata ------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return self.channel.shape

    @property
    def dtype(self):
        return self.channel.dtype

    @property
    def ndim(self) -> int:
        return len(self.channel.shape)

    def __repr__(self) -> str:
        return (f"Plane({self.channel.name}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)})")

    def astype(self, dtype) -> "Plane":
        """Record an elementwise cast to ``dtype``."""
        if as_dtype(dtype) == as_dtype(self.dtype):
            return self
        return self.tracer.point(self, _identity, key=("cast",),
                                 dtype=dtype)

    # -- arithmetic ----------------------------------------------------
    # Reflected dunders only ever see non-Plane operands (Plane-Plane
    # dispatch always resolves on the left), so each one just names the
    # scalar-closure factory for its orientation.
    def __add__(self, other):
        return self._arith("add", other, add, offset, fold_const=0.0)

    __radd__ = __add__                  # + is commutative

    def __sub__(self, other):
        return self._arith("sub", other, sub, subc, fold_const=0.0)

    def __rsub__(self, other):
        return self._arith("rsub", other, None, rsub)

    def __mul__(self, other):
        return self._arith("mul", other, mul, scale, fold_const=1.0,
                           same_fn=square)

    __rmul__ = __mul__                  # * is commutative

    def __truediv__(self, other):
        return self._arith("div", other, div, divc, fold_const=1.0,
                           inexact=True)

    def __rtruediv__(self, other):
        return self._arith("rdiv", other, None, rdiv, inexact=True)

    def __pow__(self, other):
        return self._arith("pow", other, _pow2, powc, fold_const=1.0)

    def __rpow__(self, other):
        return self._arith("rpow", other, None, rpowc)

    def __neg__(self):
        return self.tracer.point(self, neg, key=("neg",))

    def __abs__(self):
        return self.tracer.point(self, torch.abs, key=("abs",))

    # -- comparisons (record bool planes for fe.where) -----------------
    def __lt__(self, other): return self._compare("lt", other, _lt)   # noqa: E704
    def __le__(self, other): return self._compare("le", other, _le)   # noqa: E704
    def __gt__(self, other): return self._compare("gt", other, _gt)   # noqa: E704
    def __ge__(self, other): return self._compare("ge", other, _ge)   # noqa: E704
    def __eq__(self, other): return self._compare("eq", other, _eq)   # noqa: E704
    def __ne__(self, other): return self._compare("ne", other, _ne)   # noqa: E704
    __hash__ = None   # planes compare symbolically; they are not keys

    # -- boolean planes ------------------------------------------------
    def __and__(self, other): return self._logical("and", other, _and)  # noqa: E704
    __rand__ = __and__

    def __or__(self, other): return self._logical("or", other, _or)     # noqa: E704
    __ror__ = __or__

    def __xor__(self, other): return self._logical("xor", other, _xor)  # noqa: E704
    __rxor__ = __xor__

    def __invert__(self):
        self._require_bool("~")
        return self.tracer.point(self, _invert, key=("invert",))

    # -- things a symbolic value cannot do -----------------------------
    def __bool__(self):
        raise TraceControlFlowError(
            f"Python control flow on traced {self!r}: `if`/`while`/"
            f"`and`/`or` would make the dataflow graph data-dependent. "
            f"Use fe.where(cond, a, b) to select values elementwise",
            user_src())

    def __iter__(self):
        raise TraceControlFlowError(
            f"cannot iterate over traced {self!r}: per-element access "
            f"is data-dependent control flow. Use fe.window for "
            f"neighborhoods or fe.reduce for aggregation", user_src())

    def __len__(self):
        raise TraceControlFlowError(
            f"len() of traced {self!r} is a concrete-value escape; use "
            f".shape instead", user_src())

    def __float__(self):
        raise TraceControlFlowError(
            f"float() would force traced {self!r} to a concrete value "
            f"at trace time; reduce it to a graph output instead",
            user_src())

    __int__ = __float__
    __index__ = __float__

    def __getitem__(self, idx):
        raise TraceLeakError(
            f"traced {self!r} has no element indexing; the dataflow "
            f"form only streams whole planes. Use fe.window(x, (kh, kw),"
            f" fn) for neighborhoods", user_src())

    def __array__(self, *a, **k):
        raise TraceLeakError(
            f"traced {self!r} leaked into NumPy (np.asarray or a NumPy "
            f"ufunc). Keep traced code inside fe ops, or wrap the array"
            f" function with fe.custom", user_src())

    # -- shared recording helpers --------------------------------------
    def _arith(self, opname: str, other, pair_fn: Callable | None,
               const_fac: Callable, fold_const: float | None = None,
               same_fn: Callable | None = None, inexact: bool = False):
        self._require_number(opname)
        if isinstance(other, Plane):
            if pair_fn is None:       # unreachable for reflected dunders
                raise TraceError(f"{opname}: Plane-Plane form is not "
                                 f"supported", user_src())
            other._require_number(opname)
            self.tracer.check_compatible(opname, self, other)
            dtype = _promote(self.dtype, other.dtype)
            if inexact:               # true division promotes int -> float
                dtype = _ensure_inexact(dtype)
            if (same_fn is not None and other.channel is self.channel
                    and as_dtype(dtype) == as_dtype(self.dtype)):
                return self.tracer.point(self, same_fn, key=(opname, "self"))
            return self.tracer.pointn([self, other], pair_fn,
                                      key=(opname,), dtype=dtype)
        c = _as_scalar(other)
        if c is None:
            raise TraceLeakError(
                f"{opname}: unsupported operand {type(other).__name__!r} "
                f"for a traced Plane — operands must be Planes or Python"
                f" scalars. For array constants, close over them in a "
                f"@pointfn or use fe.custom", user_src())
        # result dtype follows jnp's weak-scalar promotion (an int Plane
        # times a float scalar becomes float — plain-array semantics)
        dtype = _scalar_result_dtype(self.dtype, c)
        if inexact:
            dtype = _ensure_inexact(dtype)
        if (fold_const is not None and c == fold_const
                and as_dtype(dtype) == as_dtype(self.dtype)):
            self.tracer.log.append(
                f"fold: {opname} by {c!r} elided (identity)")
            return self
        return self.tracer.point(self, const_fac(c), key=(opname, "c", c),
                                 dtype=dtype)

    def _compare(self, opname: str, other, pair_fn: Callable):
        if isinstance(other, Plane):
            self.tracer.check_compatible(opname, self, other)
            return self.tracer.pointn([self, other], pair_fn,
                                      key=("cmp", opname),
                                      dtype=torch.bool)
        c = _as_scalar(other)
        if c is None:
            raise TraceLeakError(
                f"comparison {opname!r}: operand must be a Plane or a "
                f"Python scalar, got {type(other).__name__!r}", user_src())
        return self.tracer.point(self, _cmpc(opname, c),
                                 key=("cmp", opname, c), dtype=torch.bool)

    def _logical(self, opname: str, other, pair_fn: Callable):
        self._require_bool(opname)
        if not isinstance(other, Plane):
            raise TraceLeakError(
                f"logical {opname!r}: both operands must be bool Planes",
                user_src())
        other._require_bool(opname)
        self.tracer.check_compatible(opname, self, other)
        return self.tracer.pointn([self, other], pair_fn,
                                  key=("logical", opname),
                                  dtype=torch.bool)

    def _require_number(self, opname: str) -> None:
        if as_dtype(self.dtype) == as_dtype(bool):
            raise TraceDtypeError(
                f"{opname!r} on a bool Plane (a comparison result); use "
                f"fe.where(cond, a, b) to turn a mask into values",
                user_src())

    def _require_bool(self, opname: str) -> None:
        if as_dtype(self.dtype) != as_dtype(bool):
            raise TraceDtypeError(
                f"{opname!r} needs bool Planes (comparison results), got "
                f"dtype {dtype_name(self.dtype)}", user_src())


def _promote(a, b):
    """Result dtype of a binary op on two planes (torch's promotion
    agrees with jnp's for the float/int/bool planes the tracer
    records)."""
    if as_dtype(a) == as_dtype(b):
        return a
    return torch.promote_types(as_dtype(a), as_dtype(b))


def _ensure_inexact(dtype):
    """Promote integer/bool dtypes to the default float (true division)."""
    if as_dtype(dtype).is_floating_point:
        return dtype
    return torch.float32


def _scalar_result_dtype(dtype, c):
    """Plane-dtype after an op with a Python scalar, jnp weak-type
    style: a float scalar promotes integer planes to the default
    float; otherwise the plane's dtype (object included) is kept."""
    if isinstance(c, float) and not as_dtype(dtype).is_floating_point:
        return torch.float32
    return dtype


def _as_scalar(v) -> int | float | None:
    """Python/NumPy scalar -> int/float (intness preserved — it feeds
    dtype promotion), else None (not a scalar)."""
    if isinstance(v, (bool, np.bool_)):
        return None
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if isinstance(v, np.ndarray) and v.ndim == 0:
        item = v.item()
        return item if isinstance(item, (int, float)) else None
    return None


# ----------------------------------------------------------------------
# the tracer context
# ----------------------------------------------------------------------
class _Tracer:
    """Records stages into a graph; owns the CSE memo and the log."""

    def __init__(self, graph: DataflowGraph, cse: bool = True):
        self.graph = graph
        self.cse = cse
        self.memo: dict[tuple, Plane] = {}
        self.log: list[str] = []
        self.finished = False

    # -- inputs --------------------------------------------------------
    def new_input(self, name: str, shape: Sequence[int], dtype) -> Plane:
        return Plane(self, self.graph.input(name, tuple(shape), dtype))

    # -- validation helpers --------------------------------------------
    def check_alive(self) -> None:
        if self.finished:
            raise TraceError(
                "this Plane's trace already finished — Planes do not "
                "outlive their trace() call", user_src())

    def check_same_trace(self, opname: str, *planes: Plane) -> None:
        self.check_alive()
        for p in planes:
            if p.tracer is not self:
                raise TraceError(
                    f"{opname}: operand {p!r} belongs to a different "
                    f"trace — Planes cannot cross trace() calls",
                    user_src())

    def check_compatible(self, opname: str, *planes: Plane) -> None:
        self.check_same_trace(opname, *planes)
        shapes = {p.shape for p in planes}
        if len(shapes) > 1:
            raise TraceShapeError(
                f"{opname}: operand shapes differ: "
                + " vs ".join(str(p.shape) for p in planes), user_src())

    # -- recording -----------------------------------------------------
    def point(self, p: Plane, fn: Callable, *, key: tuple,
              dtype=None, name: str | None = None,
              ii: float = 1.0, fill: float = 8.0) -> Plane:
        return self.record("point", [p], fn, key=key, dtype=dtype,
                           name=name, ii=ii, fill=fill)

    def pointn(self, planes: list[Plane], fn: Callable, *, key: tuple,
               dtype=None, name: str | None = None,
               ii: float = 1.0, fill: float = 8.0) -> Plane:
        if len(planes) == 1:
            return self.point(planes[0], fn, key=key, dtype=dtype,
                              name=name, ii=ii, fill=fill)
        return self.record("pointN", planes, fn, key=key, dtype=dtype,
                           name=name, ii=ii, fill=fill)

    def record(self, kind: str, planes: Sequence[Plane], fn: Callable,
               *, key: tuple, window: tuple[int, int] = (1, 1),
               dtype=None, out_shape: tuple[int, ...] | None = None,
               name: str | None = None, ii: float = 1.0,
               fill: float = 8.0) -> Plane:
        """Record one single-output stage; returns its output Plane."""
        self.check_alive()
        for p in planes:
            if p.tracer is not self:
                raise TraceError(
                    f"{kind} op: operand {p!r} belongs to a different "
                    f"trace", user_src())
        src = user_src()
        dtype = dtype if dtype is not None else planes[0].dtype
        shape = tuple(out_shape) if out_shape is not None \
            else planes[0].shape
        full_key = (kind, key, tuple(id(p.channel) for p in planes),
                    window, dtype_name(dtype), shape)
        if self.cse and full_key in self.memo:
            hit = self.memo[full_key]
            self.log.append(
                f"cse: reused {kind} {name or key[0]} -> "
                f"channel {hit.channel.name!r}")
            return hit
        out = self.graph.channel(shape, dtype)
        self.graph.task(name or self.graph._fresh(kind), kind, fn,
                        [p.channel for p in planes], [out],
                        window=window, ii=ii, fill=fill,
                        meta={"src": src})
        plane = Plane(self, out)
        self.memo[full_key] = plane
        return plane

    def record_custom(self, planes: Sequence[Plane], fn: Callable, *,
                      out_shapes: Sequence[tuple[int, ...]],
                      out_dtypes: Sequence[Any],
                      name: str | None = None) -> tuple[Plane, ...]:
        """Record an opaque multi-output ``custom`` stage."""
        self.check_alive()
        src = user_src()
        outs = self.graph.custom([p.channel for p in planes], fn,
                                 [tuple(s) for s in out_shapes],
                                 list(out_dtypes), name=name,
                                 meta={"src": src})
        return tuple(Plane(self, ch) for ch in outs)


# ----------------------------------------------------------------------
# pointfn: lift a plain elementwise function into the traceable library
# ----------------------------------------------------------------------
class PointFn:
    """A named elementwise function usable on arrays AND on Planes.

    Called with arrays it just computes; called with Planes it records
    ONE ``point``/``pointN`` stage whose body is the undecorated
    function (``.fn``) — so every trace of a program shares the exact
    same stage functions, and their structural signatures match.

    >>> from repro_torch.frontend.tracer import pointfn
    >>> @pointfn
    ... def luma(r, g, b):
    ...     return 0.299 * r + 0.587 * g + 0.114 * b
    >>> round(luma(1.0, 1.0, 1.0), 3)     # plain call: just computes
    1.0
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        functools.update_wrapper(self, fn)

    def __call__(self, *args):
        planes = [a for a in args if isinstance(a, Plane)]
        if not planes:
            return self.fn(*args)
        if len(planes) != len(args):
            raise TraceError(
                f"@pointfn {self.__name__!r} called with a mix of "
                f"Planes and scalars; close over scalars in a factory "
                f"instead (def make(c): @pointfn def f(x): ... c ...)",
                user_src())
        tracer = planes[0].tracer
        tracer.check_compatible(self.__name__, *planes)
        return tracer.pointn(list(args), self.fn,
                             key=("fn", id(self.fn)), name=self.__name__)

    def __repr__(self) -> str:
        return f"pointfn({self.__name__})"


def pointfn(fn: Callable) -> PointFn:
    """Decorator form of :class:`PointFn`."""
    return PointFn(fn)


# ----------------------------------------------------------------------
# input specs + the trace entry point
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape/dtype/name of one traced input (``fe.spec(...)``)."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    name: str | None = None


def _as_spec(s, param_name: str) -> InputSpec:
    if isinstance(s, InputSpec):
        return InputSpec(tuple(s.shape), as_dtype(s.dtype),
                         s.name or param_name)
    if isinstance(s, (tuple, list)) and all(
            isinstance(d, (int, np.integer)) for d in s):
        return InputSpec(tuple(int(d) for d in s), torch.float32, param_name)
    if hasattr(s, "shape") and hasattr(s, "dtype"):   # array / SDS
        return InputSpec(tuple(s.shape), as_dtype(s.dtype), param_name)
    raise TraceError(
        f"input spec for parameter {param_name!r} must be a shape "
        f"tuple, an fe.spec(...), or an array-like with .shape/.dtype; "
        f"got {type(s).__name__!r}")


def _positional_params(fn: Callable) -> list[str]:
    sig = inspect.signature(fn)
    params = []
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            params.append(p.name)
        elif p.kind is p.VAR_POSITIONAL:
            raise TraceError(
                f"cannot trace {fn.__name__!r}: *args parameters have "
                f"no fixed input arity; spell the inputs out")
    return params


def trace(fn: Callable, *specs, name: str | None = None,
          cse: bool = True, canonicalize: bool = True) -> DataflowGraph:
    """Trace ``fn`` over symbolic Planes; return its dataflow graph.

    One :class:`InputSpec` (or bare shape tuple, or array-like) per
    positional parameter of ``fn``; graph input names default to the
    parameter names.  ``fn`` returns a Plane (output name ``out``), a
    tuple of Planes (``out0``, ``out1``, …) or a ``{name: Plane}``
    dict.  With ``canonicalize=True`` (default) the returned graph has
    already been through the standard pass pipeline — auto-split,
    dead-channel elimination, point fusion — so it validates cleanly
    and its :meth:`~repro_torch.core.graph.DataflowGraph.signature` is the
    canonical one.  ``cse=False`` disables trace-time common-
    subexpression elimination (for differential testing; results are
    bit-identical either way).

    The trace-time log (CSE hits, constant folds, pass diagnostics)
    is attached as ``graph.frontend_log``.

    >>> import numpy as np
    >>> from repro_torch.frontend.tracer import trace
    >>> def blur_diff(img):
    ...     doubled = img * 2.0
    ...     return doubled - img
    >>> g = trace(blur_diff, (8, 128))
    >>> out = g.reference_eval({"img": np.full((8, 128), 3.0,
    ...                                        np.float32)})
    >>> float(out["out"][0, 0])
    3.0
    """
    params = _positional_params(fn)
    if len(specs) != len(params):
        raise TraceError(
            f"{fn.__name__!r} takes {len(params)} inputs "
            f"({', '.join(params)}) but {len(specs)} spec(s) were given")
    inspecs = [_as_spec(s, p) for s, p in zip(specs, params)]
    names = [s.name for s in inspecs]
    if len(set(names)) != len(names):
        raise TraceError(f"duplicate input names: {names}")

    graph = DataflowGraph(name or fn.__name__)
    tracer = _Tracer(graph, cse=cse)
    planes = [tracer.new_input(s.name, s.shape, s.dtype) for s in inspecs]
    result = fn(*planes)

    outputs = _normalize_outputs(result)
    if not outputs:
        raise TraceLeakError(
            f"traced function {fn.__name__!r} returned no outputs "
            f"(empty tuple/dict); a dataflow app must produce at least "
            f"one output plane")
    marked: set[int] = set()
    for oname, plane in outputs.items():
        if not isinstance(plane, Plane):
            raise TraceLeakError(
                f"traced function {fn.__name__!r} returned a "
                f"{type(plane).__name__!r} for output {oname!r}; every "
                f"output must be a Plane (a value computed outside the "
                f"fe ops leaked out of the trace)")
        if plane.tracer is not tracer:
            raise TraceError(
                f"output {oname!r} belongs to a different trace")
        if oname in names:
            raise TraceError(
                f"output name {oname!r} collides with an input name")
        ch = plane.channel
        if ch.is_graph_input or id(ch) in marked:
            # returning an input (or one channel under two names): give
            # the output its own producer via an identity point stage
            plane = tracer.point(plane, _identity, key=("out", oname))
            ch = plane.channel
        marked.add(id(ch))
        graph.output(ch, oname)

    tracer.finished = True
    pass_log: list[str] = []
    if canonicalize:
        graph, pass_log = default_pipeline().run(graph)
        graph.validate()
    graph.frontend_log = tracer.log + pass_log
    return graph


def _normalize_outputs(result) -> dict[str, Any]:
    if isinstance(result, Plane):
        return {"out": result}
    if isinstance(result, (tuple, list)):
        return {f"out{i}": p for i, p in enumerate(result)}
    if isinstance(result, Mapping):
        bad = [k for k in result if not isinstance(k, str)]
        if bad:
            raise TraceError(f"output dict keys must be strings: {bad}")
        return dict(result)
    raise TraceLeakError(
        f"traced function must return Plane(s) (single, tuple, or "
        f"{{name: Plane}} dict); got {type(result).__name__!r}")


# ----------------------------------------------------------------------
# @dataflow_fn: a traced function as a servable, tunable app
# ----------------------------------------------------------------------
class DataflowFunction:
    """A traced single-source program, compile-on-demand.

    Wraps a plain array function so that *calling it on arrays* runs
    it through the full FLOWER pipeline: trace → canonicalize →
    partition → lower → host app, memoized per input-shape/backend.
    The explicit steps are also exposed: :meth:`trace` (just the
    graph), :meth:`compile` (a :class:`~repro_torch.core.host.CompiledApp`),
    and :meth:`graph_for` (the graph matching a dict of concrete
    inputs).

    Decorator keywords become default ``compile_graph`` kwargs, so
    ``@dataflow_fn(backend="cuda_stream", device="cpu")`` gives a function
    that compiles and runs with no explicit graph, channel, or split
    construction anywhere in user code.
    """

    def __init__(self, fn: Callable, *, name: str | None = None,
                 cse: bool = True, **compile_kwargs: Any):
        self.fn = fn
        self.name = name or fn.__name__
        self.cse = cse
        self.compile_kwargs = dict(compile_kwargs)
        self._params = _positional_params(fn)
        self._graphs: dict[tuple, DataflowGraph] = {}
        self._apps: dict[tuple, Any] = {}
        #: non-primitive compile kwargs ever seen; pinned so the id()
        #: component of a memo key can never be a recycled address
        self._pinned: list[Any] = []
        functools.update_wrapper(self, fn)

    # -- graph level ---------------------------------------------------
    def trace(self, *specs) -> DataflowGraph:
        params = self._params
        if len(specs) != len(params):
            raise TraceError(
                f"{self.name!r} takes {len(params)} inputs "
                f"({', '.join(params)}); got {len(specs)} spec(s)")
        inspecs = tuple(_as_spec(s, p) for s, p in zip(specs, params))
        key = self._spec_key(inspecs)
        if key not in self._graphs:
            self._graphs[key] = trace(self.fn, *inspecs, name=self.name,
                                      cse=self.cse)
        return self._graphs[key]

    def graph_for(self, inputs: Mapping[str, Any]) -> DataflowGraph:
        """The traced graph matching a ``{input_name: array}`` dict."""
        missing = [p for p in self._params if p not in inputs]
        if missing:
            raise TraceError(
                f"{self.name!r}: missing inputs {missing}; expected "
                f"{self._params}")
        return self.trace(*[inputs[p] for p in self._params])

    # -- app level -----------------------------------------------------
    def compile(self, *specs, **overrides: Any):
        """Compile for the given input specs; memoized.

        ``overrides`` merge over the decorator's ``compile_kwargs``
        (e.g. ``backend=``, ``tune="auto"``, ``tune_cache=``).  The
        memo keys on the *spec key* (which uniquely determines the
        memoized graph), so a warm call never rehashes the graph."""
        if len(specs) != len(self._params):
            raise TraceError(
                f"{self.name!r} takes {len(self._params)} inputs "
                f"({', '.join(self._params)}); got {len(specs)} spec(s)")
        inspecs = tuple(_as_spec(s, p)
                        for s, p in zip(specs, self._params))
        kwargs = {**self.compile_kwargs, **overrides}
        key = (self._spec_key(inspecs), self._freeze(kwargs))
        if key not in self._apps:
            from repro_torch.core.compiler import compile_graph
            self._apps[key] = compile_graph(self.trace(*inspecs),
                                            **kwargs)
        return self._apps[key]

    def __call__(self, *args, **kwargs):
        params = self._params
        bound = list(args)
        for p in params[len(args):]:
            if p not in kwargs:
                raise TraceError(
                    f"{self.name!r}: missing input {p!r}; expected "
                    f"{params}")
            bound.append(kwargs.pop(p))
        if len(bound) != len(params) or kwargs:
            raise TraceError(
                f"{self.name!r} expects inputs {params}; got "
                f"{len(bound)} positional + extras {sorted(kwargs)}")
        # pass device arrays through untouched (no host round-trip);
        # only lift bare lists/scalars so .shape/.dtype exist
        arrays = [a if hasattr(a, "shape") and hasattr(a, "dtype")
                  else np.asarray(a) for a in bound]
        app = self.compile(*arrays)
        out = app(**dict(zip(params, arrays)))
        if set(out) == {"out"}:
            return out["out"]
        return out

    def __repr__(self) -> str:
        return f"dataflow_fn({self.name})"

    @staticmethod
    def _spec_key(inspecs: Sequence[InputSpec]) -> tuple:
        return tuple((s.name, s.shape, dtype_name(s.dtype))
                     for s in inspecs)

    def _freeze(self, kwargs: Mapping[str, Any]) -> tuple:
        out = []
        for k in sorted(kwargs):
            v = kwargs[k]
            if isinstance(v, torch.device):
                v = str(v)
            if not isinstance(v, (str, int, float, bool, bytes, tuple,
                                  type(None))):
                # a Backend keys by its cache_key(), so equal-by-value
                # instances share one compiled app
                ck = getattr(v, "cache_key", None)
                if callable(ck):
                    v = f"{type(v).__name__}:{ck()}"
                if not isinstance(v, str):
                    if all(v is not p for p in self._pinned):
                        self._pinned.append(v)
                    v = f"id{id(v)}"
            out.append((k, v))
        return tuple(out)


def dataflow_fn(fn: Callable | None = None, **kwargs: Any):
    """Decorate a plain array function into a :class:`DataflowFunction`.

    Bare (``@dataflow_fn``) or configured
    (``@dataflow_fn(backend="torch", device="cpu")``).
    """
    if fn is None:
        return lambda f: DataflowFunction(f, **kwargs)
    return DataflowFunction(fn, **kwargs)
