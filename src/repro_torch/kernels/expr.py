"""Expression recorder: turn a stage body into a C expression.

Stage bodies are Python closures over torch tensors, and a CUDA kernel
cannot call them.  Running a body on :class:`Expr` stand-ins records
what it computes as an expression DAG instead: :class:`Expr`
implements the arithmetic (``+ - * / // % **``), comparison,
``& | ^ ~`` operators, ``.to(dtype)`` and ``__torch_function__`` for
the torch math the frontend offers (``torch.sqrt/exp/log/abs/tanh/sin/
cos/sign``, ``maximum/minimum/clamp/where``).  A stencil body receives
a :class:`Patches` stand-in whose ``p[i]`` is the tap at window offset
``(i // kw, i % kw)``.

Every value has a kind, the type it holds: float32, bfloat16, float16,
int32 or bool (:data:`KINDS`).  Kinds combine as JAX's (and torch's)
type promotion does: a Python scalar is weak and takes the other
operand's kind (an int scalar beside a bool gives int32, a float scalar
beside an int or a bool float32); bfloat16 with float16 gives float32;
true division of ints gives float32.  A bfloat16 or float16 operation
computes in float32 and rounds its result to its type, as torch and JAX
do for each op on such an array; the scalar stays float32, as torch's
CUDA kernels keep it.  Int arithmetic wraps at 32 bits; ``//`` and
``%`` floor (Python's and ``jnp``'s semantics, not C's truncation).

The DAG is then emitted as C statements (:func:`emit_c`) for the group
and pipeline kernels, or evaluated with torch (:func:`evaluate`, the
kernel's arithmetic op by op) so the tests can hold the recording
against the body run on tensors.  Emission keeps the reference's
arithmetic exactly: float32 constants as C hex-float literals,
``x ** n`` for an integer ``n`` as the multiplications JAX's
``integer_pow`` performs, and NaN-propagating max/min like torch's.
Anything else raises :class:`RecordError`.
"""
from __future__ import annotations

import numbers
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Expr", "Patches", "RecordError", "RECORD_ERRORS", "record",
           "emit_c", "evaluate", "count_ops", "leaves", "cast", "kind_of",
           "KINDS", "DTYPES", "C_TYPES", "C_STORE", "F", "B", "I", "BF",
           "HF"]

# value kinds: float32, bool, int32, bfloat16, float16
F, B, I, BF, HF = "f", "b", "i", "bf", "hf"
FLOATS = (F, BF, HF)
#: torch dtype -> the kind that holds it
KINDS = {torch.float32: F, torch.bool: B, torch.int32: I,
         torch.bfloat16: BF, torch.float16: HF}
#: kind -> the torch dtype it holds
DTYPES = {k: d for d, k in KINDS.items()}
#: the C type a kind computes in (bfloat16 and float16 in float, rounded
#: after every operation)
C_TYPES = {F: "float", BF: "float", HF: "float", I: "int", B: "bool"}
#: the C type a kind is stored in, in device and shared memory
C_STORE = {F: "float", BF: "__nv_bfloat16", HF: "__half", I: "int",
           B: "bool"}
_RANK = {B: 0, I: 1, BF: 2, HF: 2, F: 3}
_INT_MIN, _INT_MAX = -2**31, 2**31 - 1


class RecordError(TypeError):
    """A stage body did something the recorder cannot express in C."""


#: errors a stage body may raise when it meets a recorder stand-in
RECORD_ERRORS = (RecordError, TypeError, ValueError, AttributeError,
                 IndexError, NotImplementedError, RuntimeError)


def kind_of(dtype: torch.dtype) -> str:
    """The kind holding ``dtype``; a type no kind holds raises."""
    if dtype not in KINDS:
        names = ", ".join(str(d).removeprefix("torch.") for d in KINDS)
        raise RecordError(f"{dtype} is not a kernel type (the kernels "
                          f"compute {names})")
    return KINDS[dtype]


class Expr:
    """One node of a recorded stage body.

    ``op`` names the operation; ``args`` holds child nodes (or, for the
    leaves, ``("in", (k, dy, dx))`` the stage input ``k`` at offset
    ``(dy, dx)`` and ``("const", (value,))``, a weak Python scalar);
    ``kind`` is the value's type (:data:`F`, :data:`BF`, :data:`HF`,
    :data:`I` or :data:`B`).
    """

    __slots__ = ("op", "args", "kind")
    __hash__ = None             # == is recorded, not compared

    def __init__(self, op: str, args: tuple, kind: str):
        self.op, self.args, self.kind = op, args, kind

    def __repr__(self) -> str:
        return f"Expr({self.op}, kind={self.kind})"

    # -- arithmetic ----------------------------------------------------
    def __add__(self, o): return _arith("add", self, o)      # noqa: E704
    def __radd__(self, o): return _arith("add", o, self)     # noqa: E704
    def __sub__(self, o): return _arith("sub", self, o)      # noqa: E704
    def __rsub__(self, o): return _arith("sub", o, self)     # noqa: E704
    def __mul__(self, o): return _arith("mul", self, o)      # noqa: E704
    def __rmul__(self, o): return _arith("mul", o, self)     # noqa: E704
    def __truediv__(self, o): return _arith("div", self, o)   # noqa: E704
    def __rtruediv__(self, o): return _arith("div", o, self)  # noqa: E704
    def __floordiv__(self, o): return _arith("floordiv", self, o)   # noqa: E704
    def __rfloordiv__(self, o): return _arith("floordiv", o, self)  # noqa: E704
    def __mod__(self, o): return _arith("mod", self, o)      # noqa: E704
    def __rmod__(self, o): return _arith("mod", o, self)     # noqa: E704

    def __neg__(self):
        return _unary("neg", self)

    def __pos__(self):
        return _number(self)

    def __abs__(self):
        return _unary("abs", self)

    def __pow__(self, o):
        x = _number(self)
        if isinstance(o, Expr):
            return _float_op("pow", x, o)
        if isinstance(o, bool) or not isinstance(o, numbers.Real):
            raise RecordError(f"unsupported exponent {o!r}")
        if isinstance(o, numbers.Integral):
            if x.kind == I and o < 0:
                raise RecordError("an int to a negative power")
            return _integer_pow(x, int(o))
        return _float_op("pow", x, _lift(o))

    def __rpow__(self, o):
        return _float_op("pow", _lift(o), _number(self))

    # -- comparisons and logic -----------------------------------------
    def __lt__(self, o): return _compare("lt", self, o)      # noqa: E704
    def __le__(self, o): return _compare("le", self, o)      # noqa: E704
    def __gt__(self, o): return _compare("gt", self, o)      # noqa: E704
    def __ge__(self, o): return _compare("ge", self, o)      # noqa: E704
    def __eq__(self, o): return _compare("eq", self, o)      # noqa: E704
    def __ne__(self, o): return _compare("ne", self, o)      # noqa: E704
    def __and__(self, o): return _logic("and", self, o)      # noqa: E704
    __rand__ = __and__
    def __or__(self, o): return _logic("or", self, o)        # noqa: E704
    __ror__ = __or__
    def __xor__(self, o): return _logic("xor", self, o)      # noqa: E704
    __rxor__ = __xor__

    def __invert__(self):
        return _unary("not", self)

    def __bool__(self):
        raise RecordError("Python control flow on a recorded value")

    # -- tensor methods stage bodies use --------------------------------
    def to(self, dtype, *args, **kwargs) -> "Expr":
        if not isinstance(dtype, torch.dtype):
            raise RecordError(f"cast to {dtype!r}")
        return cast(self, kind_of(dtype))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name in _UNARY and not kwargs and len(args) == 1:
            return _unary(_UNARY[name], args[0])
        if name in _BINARY and len(args) == 2 and not kwargs:
            op, fn = _BINARY[name]
            return fn(op, args[0], args[1])
        if name in ("clamp", "clip", "clamp_min", "clamp_max"):
            return _clamp(name, args, kwargs)
        if name == "where" and len(args) == 3 and not kwargs:
            c, a, b = (_lift(v) for v in args)
            if c.kind != B:
                raise RecordError("a where condition that is not bool")
            k = _result(a, b)
            return Expr("where", (c, cast(a, k), cast(b, k)), k)
        if name in ("square",) and len(args) == 1 and not kwargs:
            x = _number(args[0])
            return Expr("mul", (x, x), x.kind)
        raise RecordError(f"torch.{name} is not supported by the kernel "
                          f"recorder")


class Patches:
    """Stand-in for a stencil stage's ``(kh*kw, ...)`` patch stack; its
    taps hold values of ``kind``."""

    def __init__(self, k: int, window: tuple[int, int], kind: str = F):
        self.k, self.window = k, window
        kh, kw = window
        self._taps = [Expr("in", (k, i // kw - (kh - 1) // 2,
                                  i % kw - (kw - 1) // 2), kind)
                      for i in range(kh * kw)]

    def __len__(self) -> int:
        return len(self._taps)

    def __getitem__(self, i):
        if not isinstance(i, numbers.Integral):
            raise RecordError(f"patch index must be an int tap number, "
                              f"got {i!r}")
        return self._taps[int(i)]

    def __iter__(self):
        return iter(self._taps)


_UNARY = {"sqrt": "sqrt", "exp": "exp", "log": "log", "abs": "abs",
          "absolute": "abs", "tanh": "tanh", "sin": "sin", "cos": "cos",
          "sign": "sign", "neg": "neg", "negative": "neg",
          "logical_not": "not", "bitwise_not": "not"}
#: ops computed in a float type whatever their operand's kind
_TRANSCENDENTAL = ("sqrt", "exp", "log", "tanh", "sin", "cos")


def _const(v) -> Expr:
    if isinstance(v, (bool, np.bool_)):
        return Expr("const", (bool(v),), B)
    if isinstance(v, (numbers.Integral, np.integer)):
        if not _INT_MIN <= int(v) <= _INT_MAX:
            raise RecordError(f"int constant {v} outside int32")
        return Expr("const", (int(v),), I)
    return Expr("const", (float(np.float32(v)),), F)


def _lift(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, (numbers.Real, np.bool_, np.floating, np.integer)):
        return _const(v)
    raise RecordError(f"unsupported operand of type {type(v).__name__}")


def _join(x: str, y: str) -> str:
    """The kind two typed values promote to."""
    if x == y:
        return x
    if {x, y} == {BF, HF}:
        return F
    return x if _RANK[x] > _RANK[y] else y


def _result(a: Expr, b: Expr) -> str:
    """The kind of ``a op b``: a weak scalar takes the typed side's kind
    where that holds it (an int scalar beside a bool gives int32, a
    float scalar beside an int or a bool float32)."""
    wa, wb = a.op == "const", b.op == "const"
    if wa == wb:
        return _join(a.kind, b.kind)
    typed, weak = (b.kind, a.kind) if wa else (a.kind, b.kind)
    if weak == F:
        return typed if typed in FLOATS else F
    if weak == I:
        return I if typed == B else typed
    return typed


def cast(e: Expr, kind: str) -> Expr:
    """``e`` as a value of ``kind`` (a constant is converted in place)."""
    e = _lift(e)
    if e.kind == kind:
        return e
    if e.op == "const":
        v = e.args[0]
        if kind == B:
            return Expr("const", (bool(v),), B)
        if kind == I:
            return Expr("const", (int(v),), I)
        return Expr("const", (float(np.float32(v)),), kind)
    return Expr("cast", (e,), kind)


def _number(e) -> Expr:
    e = _lift(e)
    if e.kind == B:
        raise RecordError("arithmetic on a bool value alone (a comparison)")
    return e


def _arith(op: str, a, b) -> Expr:
    a, b = _lift(a), _lift(b)
    if a.kind == B and b.kind == B:
        raise RecordError("arithmetic on two bool values")
    k = _result(a, b)
    if k == B:
        k = I
    if op == "div" and k == I:           # true division promotes
        k = F
    return Expr(op, (cast(a, k), cast(b, k)), k)


def _float_op(op: str, a, b) -> Expr:
    """A binary op computed in a float type (``pow``)."""
    a, b = _lift(a), _lift(b)
    k = _result(a, b)
    if k not in FLOATS:
        k = F
    return Expr(op, (cast(a, k), cast(b, k)), k)


def _compare(op: str, a, b) -> Expr:
    a, b = _lift(a), _lift(b)
    k = _result(a, b)
    return Expr(op, (cast(a, k), cast(b, k)), B)


def _minmax(op: str, a, b) -> Expr:
    a, b = _lift(a), _lift(b)
    k = _result(a, b)
    if k == B:
        raise RecordError(f"{op} of bool values")
    return Expr(op, (cast(a, k), cast(b, k)), k)


def _logic(op: str, a, b) -> Expr:
    a, b = _lift(a), _lift(b)
    k = _result(a, b)
    if k not in (B, I):
        raise RecordError("logic on a float value")
    return Expr(op, (cast(a, k), cast(b, k)), k)


_BINARY = {"maximum": ("max", _minmax), "max": ("max", _minmax),
           "fmax": ("max", _minmax), "minimum": ("min", _minmax),
           "min": ("min", _minmax), "fmin": ("min", _minmax),
           "floor_divide": ("floordiv", _arith),
           "remainder": ("mod", _arith),
           "bitwise_and": ("and", _logic), "bitwise_or": ("or", _logic),
           "bitwise_xor": ("xor", _logic), "logical_and": ("and", _logic),
           "logical_or": ("or", _logic), "logical_xor": ("xor", _logic)}


def _unary(op: str, x) -> Expr:
    x = _lift(x)
    if op == "not":
        if x.kind not in (B, I):
            raise RecordError("logic on a float value")
        return Expr("not", (x,), x.kind)
    x = _number(x)
    if op in _TRANSCENDENTAL and x.kind not in FLOATS:
        x = cast(x, F)
    return Expr(op, (x,), x.kind)


def _integer_pow(x: Expr, n: int) -> Expr:
    """``x ** n`` by square-and-multiply, as ``lax.integer_pow`` does."""
    if n == 0:
        return cast(_const(1), x.kind)
    y, acc, base = abs(n), None, x
    while y:
        if y & 1:
            acc = base if acc is None else Expr("mul", (acc, base), x.kind)
        y >>= 1
        if y:
            base = Expr("mul", (base, base), x.kind)
    return _arith("div", 1.0, acc) if n < 0 else acc


def _clamp(name: str, args, kwargs) -> Expr:
    x = _number(args[0])
    rest = list(args[1:]) + [None, None]
    if name == "clamp_min":
        lo, hi = kwargs.get("min", rest[0]), None
    elif name == "clamp_max":
        lo, hi = None, kwargs.get("max", rest[0])
    else:
        lo, hi = kwargs.get("min", rest[0]), kwargs.get("max", rest[1])
    for op, bound in (("clamp_min", lo), ("clamp_max", hi)):
        if bound is not None:
            bound = _number(bound)
            k = _result(x, bound)
            x = Expr(op, (cast(x, k), cast(bound, k)), k)
    return x


def record(fn: Callable, args: list) -> Expr:
    """Run ``fn`` on stand-ins; the result as an :class:`Expr`."""
    out = fn(*args)
    if isinstance(out, (tuple, list)):
        raise RecordError("a stage body must return one value")
    return _lift(out)


# ----------------------------------------------------------------------
# emission
# ----------------------------------------------------------------------
_C_BIN = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
          "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_C_LOGIC = {B: {"and": "&&", "or": "||", "xor": "!="},
            I: {"and": "&", "or": "|", "xor": "^"}}
_C_FN = {"sqrt": "sqrtf", "exp": "expf", "log": "logf", "abs": "fabsf",
         "tanh": "tanhf", "sin": "sinf", "cos": "cosf", "sign": "sg::sign",
         "max": "sg::fmax_nan", "min": "sg::fmin_nan",
         "clamp_min": "sg::clamp_min", "clamp_max": "sg::clamp_max",
         "pow": "powf", "floordiv": "sg::floordiv", "mod": "sg::mod"}
#: int32 ops, wrapping at 32 bits (sg:: helpers in csrc/stream_group.cuh)
_C_INT = {"add": "sg::iadd", "sub": "sg::isub", "mul": "sg::imul",
          "neg": "sg::ineg", "abs": "sg::iabs", "sign": "sg::isign",
          "max": "sg::imax", "min": "sg::imin", "clamp_min": "sg::imax",
          "clamp_max": "sg::imin", "floordiv": "sg::floordiv",
          "mod": "sg::mod"}
#: rounding of a float32 result to the kind's type
_ROUND = {BF: "sg::round_bf16", HF: "sg::round_f16"}


def c_float(v: float) -> str:
    """An exact C literal for a float32 value (hex float)."""
    if v != v:
        return "__int_as_float(0x7fc00000)"
    if v in (float("inf"), float("-inf")):
        return ("" if v > 0 else "-") + "__int_as_float(0x7f800000)"
    return f"({float(np.float32(v)).hex()}f)"


def _c_const(v, kind: str) -> str:
    if kind == B:
        return "true" if v else "false"
    if kind == I:
        return f"({v})" if v > _INT_MIN else "(-2147483647 - 1)"
    return c_float(v)


def _c_cast(a: str, src: str, dst: str) -> str:
    if dst == B:
        return f"({a} != 0)" if src == I else f"({a} != 0.0f)"
    if src == B:
        return f"((int){a})" if dst == I else f"({a} ? 1.0f : 0.0f)"
    if dst == I:
        return f"((int){a})"           # float -> int truncates, as torch
    v = f"((float){a})" if src == I else a
    return f"{_ROUND[dst]}({v})" if dst in _ROUND and src != dst else v


def _topo(roots: list[Expr]) -> list[Expr]:
    order: list[Expr] = []
    seen: set[int] = set()
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        e, done = stack.pop()
        if done:
            order.append(e)
            continue
        if id(e) in seen:
            continue
        seen.add(id(e))
        stack.append((e, True))
        if e.op not in ("in", "const"):
            stack.extend((a, False) for a in reversed(e.args)
                         if id(a) not in seen)
    return order


def _c_op(e: Expr, a: list[str]) -> str:
    """The C expression of one operation on its operands' names."""
    kind = e.kind
    if e.op == "cast":
        return _c_cast(a[0], e.args[0].kind, kind)
    if e.op in ("lt", "le", "gt", "ge", "eq", "ne"):
        return f"({a[0]} {_C_BIN[e.op]} {a[1]})"
    if e.op in ("and", "or", "xor"):
        return f"({a[0]} {_C_LOGIC[kind][e.op]} {a[1]})"
    if e.op == "not":
        return f"(!{a[0]})" if kind == B else f"(~{a[0]})"
    if e.op == "where":
        rhs = f"({a[0]} ? {a[1]} : {a[2]})"
    elif kind == I:
        rhs = f"{_C_INT[e.op]}({', '.join(a)})"
    elif e.op in _C_BIN:
        rhs = f"({a[0]} {_C_BIN[e.op]} {a[1]})"
    elif e.op == "neg":
        rhs = f"(-{a[0]})"
    else:
        rhs = f"{_C_FN[e.op]}({', '.join(a)})"
    return f"{_ROUND[kind]}({rhs})" if kind in _ROUND else rhs


def emit_c(root: Expr, leaf: Callable[[int, int, int], str]
           ) -> tuple[list[str], str]:
    """C statements computing ``root``; returns ``(lines, result)``.

    ``leaf(k, dy, dx)`` renders the read of stage input ``k`` at tap
    offset ``(dy, dx)`` as a value of the leaf's kind's C type
    (:data:`C_TYPES`).  Every node is computed once, in dependency
    order, into a ``const`` temporary; the result is a value of the
    root's kind's C type.
    """
    names: dict[int, str] = {}
    lines: list[str] = []
    for e in _topo([root]):
        if e.op == "const":
            names[id(e)] = _c_const(e.args[0], e.kind)
            continue
        if e.op == "in":
            rhs = leaf(*e.args)
        else:
            rhs = _c_op(e, [names[id(x)] for x in e.args])
        name = f"t{len(lines)}"
        lines.append(f"const {C_TYPES[e.kind]} {name} = {rhs};")
        names[id(e)] = name
    return lines, names[id(root)]


def leaves(root: Expr) -> list[tuple[int, int, int]]:
    """The distinct ``(k, dy, dx)`` input taps ``root`` reads, in
    dependency order."""
    out: list[tuple[int, int, int]] = []
    for e in _topo([root]):
        if e.op == "in" and e.args not in out:
            out.append(e.args)
    return out


def count_ops(root: Expr, cost: dict[str, int] | None = None) -> int:
    """Arithmetic operations per output element (leaves excluded), each
    weighted by ``cost`` (op name -> weight, 1 where absent) if given."""
    cost = cost or {}
    return sum(cost.get(e.op, 1) for e in _topo([root])
               if e.op not in ("in", "const"))


# ----------------------------------------------------------------------
# evaluation with torch (what the tests hold against the stage body)
# ----------------------------------------------------------------------
_T_FN: dict[str, Callable[..., Any]] = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "floordiv": torch.floor_divide, "mod": torch.remainder,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne, "neg": torch.neg, "sqrt": torch.sqrt,
    "exp": torch.exp, "log": torch.log, "abs": torch.abs,
    "tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos,
    "sign": torch.sign, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow,
}
_T_LOGIC = {B: {"and": torch.logical_and, "or": torch.logical_or,
                "xor": torch.logical_xor, "not": torch.logical_not},
            I: {"and": torch.bitwise_and, "or": torch.bitwise_or,
                "xor": torch.bitwise_xor, "not": torch.bitwise_not}}


def _compute_dtype(kind: str) -> torch.dtype:
    return torch.float32 if kind in FLOATS else DTYPES[kind]


def evaluate(root: Expr, leaf: Callable[[int, int, int], torch.Tensor]
             ) -> torch.Tensor:
    """Evaluate the DAG with torch ops as the kernel computes it: each
    operation in its kind's C type (float32 for bfloat16 and float16),
    its result rounded to the kind's type; ``leaf`` supplies input taps.
    The result is a tensor of the root's kind's type."""
    vals: dict[int, Any] = {}
    like = None
    for e in _topo([root]):
        if e.op == "const":
            vals[id(e)] = e.args[0]
            continue
        if e.op == "in":
            v = leaf(*e.args)
            like = v
        else:
            dev = next((vals[id(x)].device for x in e.args
                        if isinstance(vals[id(x)], torch.Tensor)), None)
            # each operand in its kind's C type
            a = [torch.as_tensor(vals[id(x)], device=dev).to(
                _compute_dtype(x.kind)) for x in e.args]
            if e.op == "cast":
                v = a[0].to(DTYPES[e.kind])
            elif e.op == "where":
                v = torch.where(*a)
            elif e.op in ("and", "or", "xor", "not"):
                v = _T_LOGIC[e.kind][e.op](*a)
            elif e.op in ("clamp_min", "clamp_max"):
                lo = e.op == "clamp_min"
                if e.kind == I:
                    v = (torch.maximum if lo else torch.minimum)(*a)
                else:
                    v = torch.clamp(a[0], **{"min" if lo else "max": a[1]})
            else:
                v = _T_FN[e.op](*a)
            if e.kind in (BF, HF):
                v = v.to(DTYPES[e.kind])
        vals[id(e)] = v
    out = vals[id(root)]
    if not isinstance(out, torch.Tensor):     # a constant stage body
        base = like if like is not None else torch.zeros(())
        out = torch.full_like(base, out, dtype=DTYPES[root.kind])
    return out
