"""Bytes and operations of one call of each LM kernel, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; the operations are those the data
needs (the live keys only), two for a multiply-add.  The formulas are
copied from ``chip_smoke.py`` (``lm_serving``'s ``bound(...)`` calls for
flash, decode attention and the MLP, ``train_kernel_rows`` for the
training shapes) and frozen here.  The operations count at the peak for
their operands' type as the configuration states it
(:func:`peaks.flops_for`), never at the rate of the route a kernel
takes.

Every function returns ``(bytes, flops)`` for one call.  A family
(``bench/counts/families/<family>.py``) lists the calls its layers make
with these, or with a formula of its own where they do not fit, and
:func:`bounds` scales its lists by the calls the port counted.
"""
from __future__ import annotations

import re
from pathlib import Path

from bench.counts import peaks


def flash_attention(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                    esize: int, causal: bool = True) -> tuple[int, int]:
    """q and the output (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), each
    ``esize`` bytes an element; Q K^T and P V over the (query, key)
    pairs the causal mask keeps."""
    n_bytes = esize * B * D * (2 * Hq * Sq + 2 * Hkv * Sk)
    if causal:
        off = Sk - Sq          # query i sees keys up to i + off
        pairs = sum(min(Sk, i + off + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return n_bytes, 4 * B * Hq * D * pairs


def decode_attention(lengths, Smax: int, Hq: int, Hkv: int, D: int,
                     q_esize: int, kv_esize: int) -> tuple[int, int]:
    """One decode step over slots whose cache index is ``lengths`` (a
    slot attends to positions 0..length, length + 1 live keys): q and
    the output (B, Hq, D), the live K and V rows, the (B, Smax) float32
    bias; Q K^T and P V over the live keys."""
    B = len(lengths)
    live = sum(int(n) + 1 for n in lengths)
    n_bytes = (2 * B * Hq * D * q_esize + 2 * live * Hkv * D * kv_esize
               + B * Smax * 4)
    return n_bytes, 4 * Hq * D * live


def fused_mlp(T: int, d: int, f: int, esize: int) -> tuple[int, int]:
    """x in and y out (T, d), the norm's weight (d,), gate, up (d, f) and
    down (f, d); three products of T x d x f."""
    return esize * (2 * T * d + d + 3 * d * f), 6 * T * d * f


def bounds(listed: dict, calls: dict) -> dict:
    """Per kernel, the least seconds of the ``calls[kernel]`` calls that
    the launch counters counted, where ``listed[kernel]`` holds
    ``(bytes, flops, peak)`` of each call that one pass makes (a
    prefill, a decode step, a training forward): the counted calls
    spread evenly over the listed ones.  A kernel that is not listed, or
    was not counted, has no bound."""
    out = {}
    for kernel, each in listed.items():
        n = calls.get(kernel, 0)
        if n and each:
            out[kernel] = n / len(each) * sum(peaks.bound_s(*c)
                                              for c in each)
    return out


# ----------------------------------------------------------------------
# the kernels' names on the device
# ----------------------------------------------------------------------
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"([A-Za-z_]\w*)\s*\(", re.S)


def device_names(kernel: str, csrc: Path) -> list[str]:
    """The ``__global__`` functions of the port's ``csrc/<kernel>.cu``:
    the names under which the profiler lists that kernel's launches (a
    kernel of several passes has several).  Read from the program's
    source at run time, so a renamed or added pass is still counted."""
    path = csrc / f"{kernel}.cu"
    if not path.exists():
        return []
    return sorted(set(_GLOBAL.findall(path.read_text())))


def pattern(names: list[str]) -> re.Pattern | None:
    """A pattern that finds any of ``names`` in a profiler row's name
    (None for no names)."""
    if not names:
        return None
    return re.compile(r"\b(?:" + "|".join(map(re.escape, names)) + r")\b")
