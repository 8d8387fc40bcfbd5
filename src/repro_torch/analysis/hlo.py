"""Collective-byte accounting from optimized (post-SPMD) HLO text (the
port's own copy of :mod:`repro.analysis.hlo`, which it imports nothing
of).

The port produces no HLO: its dry run counts the bytes its own
collectives move (:mod:`repro_torch.parallel.traffic`) under the keys
:func:`collective_bytes` returns.  This parser reads HLO text that XLA
wrote, so the two counts can be set side by side.

``cost_analysis()`` has no collective term, so we parse
``compiled.as_text()``: every ``all-gather`` / ``all-reduce`` /
``reduce-scatter`` / ``all-to-all`` / ``collective-permute`` op's
result shape is summed (tuples expanded).  Conventions:

- all-reduce / all-gather / all-to-all / collective-permute: wire
  volume ~= result bytes (per participant, up to the (P-1)/P ring
  factor which we fold into the link-bandwidth constant).
- reduce-scatter: the result is 1/g of the input; we scale by the
  replica-group size ``g`` so the reported bytes are the *reduced*
  volume, comparable to an all-reduce of the same tensor.

Output: {"all-gather": bytes, ..., "total": bytes, "ops": n}.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["collective_bytes", "shape_bytes", "count_ops"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*(?:\},?\{[^}]*)*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string, tuples included:
    'f32[16,128]' or '(bf16[4,8]{1,0}, u32[])'."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = int(np.prod([int(d) for d in dims.split(",") if d])) \
            if dims else 1
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # iota format [n_groups,group_size]<=[...]
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1).split("}")[0]
        return max(1, len([t for t in first.split(",") if t.strip()]))
    return 1


def collective_bytes(hlo_text: str) -> dict[str, float]:
    """Sum collective wire bytes per op kind over an HLO module."""
    out: dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    n_ops = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        # result type precedes '=':   %x = TYPE opname(...)
        if "=" not in s:
            continue
        lhs, rhs = s.split("=", 1)
        rhs = rhs.strip()
        kind = None
        for k in COLLECTIVES:
            # match 'bf16[...] all-gather(' and fusion-free starts only
            if re.match(rf"[^a-z]*[\w\[\],\{{\}}()\s]*\s{k}\(", rhs) or \
               re.search(rf"\s{k}\(", rhs) or rhs.startswith(k + "("):
                kind = k
                break
        if kind is None:
            continue
        if f" {kind}(" not in " " + rhs and not rhs.startswith(kind + "("):
            continue
        # the result type is the text before the op name
        head = rhs.split(kind + "(")[0]
        b = shape_bytes(head)
        if b == 0:
            continue
        if kind == "reduce-scatter":
            b *= _group_size(s)
        out[kind] += b
        n_ops += 1
    out["total"] = float(sum(out[k] for k in COLLECTIVES))
    out["ops"] = n_ops
    return out


def count_ops(hlo_text: str, names: tuple[str, ...] = ("fusion", "dot",
              "convolution", "scatter", "gather", "while")) -> dict[str, int]:
    counts = {n: 0 for n in names}
    for line in hlo_text.splitlines():
        for n in names:
            if re.search(rf"\s{n}(\.|\()", line):
                counts[n] += 1
    return counts
