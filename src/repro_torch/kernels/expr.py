"""Expression recorder: turn a stage body into a C expression.

Stage bodies are Python closures over torch tensors, and a CUDA kernel
cannot call them.  Running a body on :class:`Expr` stand-ins records
what it computes as an expression DAG instead: :class:`Expr`
implements the arithmetic, comparison, ``& | ^ ~`` and ``**``
operators and ``__torch_function__`` for the torch math the frontend
offers (``torch.sqrt/exp/log/abs/tanh/sin/cos/sign``,
``maximum/minimum/clamp/where``).  A stencil body receives a
:class:`Patches` stand-in whose ``p[i]`` is the tap at window offset
``(i // kw, i % kw)``.

The DAG is then emitted as C statements (:func:`emit_c`) for the group
kernel, or evaluated with torch (:func:`evaluate`) so the tests can hold
the recording against the body run on tensors.  Emission keeps the
reference's arithmetic exactly: float32 constants as C hex-float
literals, ``x ** n`` for an integer ``n`` as the multiplications JAX's
``integer_pow`` performs, and NaN-propagating max/min like torch's.
Anything else raises :class:`RecordError`.
"""
from __future__ import annotations

import numbers
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Expr", "Patches", "RecordError", "RECORD_ERRORS", "record",
           "emit_c", "evaluate", "count_ops", "leaves"]

F, B = "f", "b"            # value kinds: float32, bool


class RecordError(TypeError):
    """A stage body did something the recorder cannot express in C."""


#: errors a stage body may raise when it meets a recorder stand-in
RECORD_ERRORS = (RecordError, TypeError, ValueError, AttributeError,
                 IndexError, NotImplementedError, RuntimeError)


class Expr:
    """One node of a recorded stage body.

    ``op`` names the operation; ``args`` holds child nodes (or, for the
    leaves, ``("in", (k, dy, dx))`` the stage input ``k`` at offset
    ``(dy, dx)`` and ``("const", (value,))``); ``kind`` is ``"f"``
    (float32) or ``"b"`` (bool).
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

    def __neg__(self):
        return Expr("neg", (_float(self),), F)

    def __pos__(self):
        return _float(self)

    def __abs__(self):
        return _unary("abs", self)

    def __pow__(self, o):
        if isinstance(o, Expr):
            return Expr("pow", (_float(self), _float(o)), F)
        if isinstance(o, bool) or not isinstance(o, numbers.Real):
            raise RecordError(f"unsupported exponent {o!r}")
        if isinstance(o, numbers.Integral):
            return _integer_pow(_float(self), int(o))
        return Expr("pow", (_float(self), _const(o)), F)

    def __rpow__(self, o):
        return Expr("pow", (_lift(o), _float(self)), F)

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
        return Expr("not", (_bool(self),), B)

    def __bool__(self):
        raise RecordError("Python control flow on a recorded value")

    # -- tensor methods stage bodies use --------------------------------
    def to(self, dtype, *args, **kwargs) -> "Expr":
        if dtype == torch.float32:
            return self if self.kind == F else Expr("cast_f", (self,), F)
        if dtype == torch.bool:
            return self if self.kind == B else Expr("cast_b", (self,), B)
        raise RecordError(f"cast to {dtype} (the kernel computes float32 "
                          f"and bool only)")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name in _UNARY and not kwargs and len(args) == 1:
            return _unary(_UNARY[name], args[0])
        if name in ("maximum", "max", "fmax") and len(args) == 2 \
                and not kwargs:
            return Expr("max", (_lift(args[0]), _lift(args[1])), F)
        if name in ("minimum", "min", "fmin") and len(args) == 2 \
                and not kwargs:
            return Expr("min", (_lift(args[0]), _lift(args[1])), F)
        if name in ("clamp", "clip", "clamp_min", "clamp_max"):
            return _clamp(name, args, kwargs)
        if name == "where" and len(args) == 3 and not kwargs:
            c, a, b = args
            a, b = _lift(a), _lift(b)
            kind = F if F in (a.kind, b.kind) else B
            if kind == F:
                a, b = _float(a), _float(b)
            return Expr("where", (_bool(_lift(c)), a, b), kind)
        if name in ("square",) and len(args) == 1 and not kwargs:
            x = _float(_lift(args[0]))
            return Expr("mul", (x, x), F)
        raise RecordError(f"torch.{name} is not supported by the kernel "
                          f"recorder")


class Patches:
    """Stand-in for a stencil stage's ``(kh*kw, ...)`` patch stack."""

    def __init__(self, k: int, window: tuple[int, int]):
        self.k, self.window = k, window
        kh, kw = window
        self._taps = [Expr("in", (k, i // kw - (kh - 1) // 2,
                                  i % kw - (kw - 1) // 2), F)
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
          "logical_not": "not"}


def _const(v) -> Expr:
    if isinstance(v, (bool, np.bool_)):
        return Expr("const", (bool(v),), B)
    return Expr("const", (float(np.float32(v)),), F)


def _lift(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, (numbers.Real, np.bool_, np.floating, np.integer)):
        return _const(v)
    raise RecordError(f"unsupported operand of type {type(v).__name__}")


def _float(e: Expr) -> Expr:
    e = _lift(e)
    if e.kind == B:
        raise RecordError("arithmetic on a bool value (a comparison)")
    return e


def _bool(e: Expr) -> Expr:
    if e.kind != B:
        raise RecordError("logic on a float value")
    return e


def _arith(op: str, a, b) -> Expr:
    return Expr(op, (_float(_lift(a)), _float(_lift(b))), F)


def _compare(op: str, a, b) -> Expr:
    return Expr(op, (_float(_lift(a)), _float(_lift(b))), B)


def _logic(op: str, a, b) -> Expr:
    return Expr(op, (_bool(_lift(a)), _bool(_lift(b))), B)


def _unary(op: str, x) -> Expr:
    x = _lift(x)
    if op == "not":
        return Expr("not", (_bool(x),), B)
    return Expr(op, (_float(x),), F)


def _integer_pow(x: Expr, n: int) -> Expr:
    """``x ** n`` by square-and-multiply, as ``lax.integer_pow`` does."""
    if n == 0:
        return _const(1.0)
    y, acc, base = abs(n), None, x
    while y:
        if y & 1:
            acc = base if acc is None else Expr("mul", (acc, base), F)
        y >>= 1
        if y:
            base = Expr("mul", (base, base), F)
    return Expr("div", (_const(1.0), acc), F) if n < 0 else acc


def _clamp(name: str, args, kwargs) -> Expr:
    x = _float(_lift(args[0]))
    rest = list(args[1:]) + [None, None]
    if name == "clamp_min":
        lo, hi = kwargs.get("min", rest[0]), None
    elif name == "clamp_max":
        lo, hi = None, kwargs.get("max", rest[0])
    else:
        lo, hi = kwargs.get("min", rest[0]), kwargs.get("max", rest[1])
    if lo is not None:
        x = Expr("clamp_min", (x, _float(_lift(lo))), F)
    if hi is not None:
        x = Expr("clamp_max", (x, _float(_lift(hi))), F)
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
          "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
          "and": "&&", "or": "||", "xor": "!="}
_C_FN = {"sqrt": "sqrtf", "exp": "expf", "log": "logf", "abs": "fabsf",
         "tanh": "tanhf", "sin": "sinf", "cos": "cosf", "sign": "sg::sign",
         "max": "sg::fmax_nan", "min": "sg::fmin_nan",
         "clamp_min": "sg::clamp_min", "clamp_max": "sg::clamp_max",
         "pow": "powf"}


def c_float(v: float) -> str:
    """An exact C literal for a float32 value (hex float)."""
    if v != v:
        return "__int_as_float(0x7fc00000)"
    if v in (float("inf"), float("-inf")):
        return ("" if v > 0 else "-") + "__int_as_float(0x7f800000)"
    return f"({float(np.float32(v)).hex()}f)"


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


def emit_c(root: Expr, leaf: Callable[[int, int, int], str]
           ) -> tuple[list[str], str]:
    """C statements computing ``root``; returns ``(lines, result)``.

    ``leaf(k, dy, dx)`` renders the read of stage input ``k`` at tap
    offset ``(dy, dx)``.  Every node is computed once, in dependency
    order, into a ``const`` temporary.
    """
    names: dict[int, str] = {}
    lines: list[str] = []
    for e in _topo([root]):
        if e.op == "const":
            v = e.args[0]
            names[id(e)] = ("true" if v else "false") if e.kind == B \
                else c_float(v)
            continue
        if e.op == "in":
            rhs = leaf(*e.args)
        else:
            a = [names[id(x)] for x in e.args]
            if e.op in _C_BIN:
                rhs = f"({a[0]} {_C_BIN[e.op]} {a[1]})"
            elif e.op == "neg":
                rhs = f"(-{a[0]})"
            elif e.op == "not":
                rhs = f"(!{a[0]})"
            elif e.op == "where":
                rhs = f"({a[0]} ? {a[1]} : {a[2]})"
            elif e.op == "cast_f":
                rhs = f"({a[0]} ? 1.0f : 0.0f)"
            elif e.op == "cast_b":
                rhs = f"({a[0]} != 0.0f)"
            else:
                rhs = f"{_C_FN[e.op]}({', '.join(a)})"
        name = f"t{len(lines)}"
        ctype = "float" if e.kind == F else "bool"
        lines.append(f"const {ctype} {name} = {rhs};")
        names[id(e)] = name
    result = names[id(root)]
    if root.kind == B:            # a bool stage output stored as float
        result = f"({result} ? 1.0f : 0.0f)"
    return lines, result


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
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
    "or": torch.logical_or, "xor": torch.logical_xor,
    "not": torch.logical_not, "neg": torch.neg, "sqrt": torch.sqrt,
    "exp": torch.exp, "log": torch.log, "abs": torch.abs,
    "tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos,
    "sign": torch.sign, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow,
}


def evaluate(root: Expr, leaf: Callable[[int, int, int], torch.Tensor]
             ) -> torch.Tensor:
    """Evaluate the DAG with torch ops; ``leaf`` supplies input taps."""
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
            a = [vals[id(x)] for x in e.args]
            if e.op == "where":
                v = torch.where(a[0], a[1], a[2])
            elif e.op == "cast_f":
                v = a[0].to(torch.float32)
            elif e.op == "cast_b":
                v = a[0] != 0
            elif e.op == "clamp_min":
                v = torch.clamp(a[0], min=a[1])
            elif e.op == "clamp_max":
                v = torch.clamp(a[0], max=a[1])
            else:
                dev = next((x.device for x in a
                            if isinstance(x, torch.Tensor)), None)
                a = [x if isinstance(x, torch.Tensor)
                     else torch.tensor(x, device=dev,
                                       dtype=torch.bool if isinstance(x, bool)
                                       else torch.float32)
                     for x in a]
                v = _T_FN[e.op](*a)
        vals[id(e)] = v
    out = vals[id(root)]
    if not isinstance(out, torch.Tensor):     # a constant stage body
        base = like if like is not None else torch.zeros(())
        out = torch.full_like(base, out, dtype=torch.bool if root.kind == B
                              else torch.float32)
    return out
