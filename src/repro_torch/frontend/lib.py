"""Shared kernel library: every coefficient table and pointwise
formula used by the Table-I apps, defined exactly once.

Port of :mod:`repro.frontend.lib`: the coefficient tables are the
reference's, bit for bit (:func:`tables`); the bodies call ``torch.*``,
which the group kernel's expression recorder records.

Every traced app draws its stage bodies from here, so stage-function
identity — which feeds
:meth:`repro_torch.core.graph.DataflowGraph.signature` — is shared.

Three families:

- **taps** — the classic stencil coefficient tables (``GAUSS3`` …),
  plus :func:`conv_taps` which unrolls a table into a patch function
  with zero-taps elided (what an FPGA synthesizer does to fixed
  coefficients).
- **local operators** — patch functions for ``stencil`` stages
  (:func:`sobel_mag`, :func:`bilateral`).
- **pointwise formulas** — ``@pointfn``-lifted elementwise math
  (:data:`luma_rec601`, :func:`harris_response`, …): call them on
  arrays to compute, on Planes to record one stage.

The canonical operator bodies (``add``, ``sub``, ``scale(c)``, …)
are re-exported from :mod:`repro_torch.frontend.tracer`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.frontend.tracer import (add, div, mul, neg, offset, pointfn,
                                   powc, scale, square, sub, subc)

__all__ = [
    "GAUSS3", "GAUSS5", "MEAN5", "SOBEL_X", "SOBEL_Y", "LAPLACE3",
    "JACOBI3", "tables",
    "conv_taps", "sobel_mag", "bilateral",
    "luma_rec601", "harris_response", "lam_min", "lk_vx", "lk_vy",
    # canonical elementwise ops (tracer re-exports)
    "add", "sub", "mul", "div", "square", "neg", "offset", "scale",
    "subc", "powc",
]


# ----------------------------------------------------------------------
# coefficient tables
# ----------------------------------------------------------------------
GAUSS3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
GAUSS5 = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float32) / 256.0
MEAN5 = np.ones((5, 5), np.float32) / 25.0
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T.copy()
LAPLACE3 = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
JACOBI3 = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]], np.float32) / 4.0


def tables() -> dict[str, np.ndarray]:
    """Every coefficient table by name (float32 numpy arrays)."""
    return {"GAUSS3": GAUSS3, "GAUSS5": GAUSS5, "MEAN5": MEAN5,
            "SOBEL_X": SOBEL_X, "SOBEL_Y": SOBEL_Y, "LAPLACE3": LAPLACE3,
            "JACOBI3": JACOBI3}


def conv_taps(weights: np.ndarray) -> Callable:
    """Patch function for a fixed coefficient table.

    Taps are unrolled as scalar multiplies (zeros elided) — the same
    constant folding an FPGA synthesizer applies to fixed
    coefficients, and it keeps stage fns free of captured array
    constants (the group kernel's recorder needs scalar taps).
    """
    taps = [float(v) for v in np.asarray(weights).reshape(-1)]

    def fn(p):
        acc = None
        for i, t in enumerate(taps):
            if t == 0.0:
                continue
            term = p[i] if t == 1.0 else p[i] * t
            acc = term if acc is None else acc + term
        return acc

    return fn


# ----------------------------------------------------------------------
# local (stencil) operators
# ----------------------------------------------------------------------
def sobel_mag(p):
    """Gradient magnitude from one 3x3 patch set (both Sobel taps)."""
    gx = conv_taps(SOBEL_X)(p)
    gy = conv_taps(SOBEL_Y)(p)
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def bilateral(sigma_s: float = 2.0, sigma_r: float = 0.25) -> Callable:
    """5x5 bilateral filter patch function (range kernel unrolled)."""
    kh = kw = 5
    ds = np.array([[(i - 2) ** 2 + (j - 2) ** 2 for j in range(kw)]
                   for i in range(kh)], np.float32).reshape(-1)
    ws = [float(v) for v in np.exp(-ds / (2 * sigma_s ** 2))]
    inv2r = 1.0 / (2 * sigma_r ** 2)

    def fn(p):
        center = p[kh * kw // 2]
        sum_w = None
        sum_wp = None
        for i, wsi in enumerate(ws):  # unrolled taps (scalar consts)
            wr = torch.exp(-(p[i] - center) ** 2 * inv2r) * wsi
            sum_w = wr if sum_w is None else sum_w + wr
            term = wr * p[i]
            sum_wp = term if sum_wp is None else sum_wp + term
        return sum_wp / (sum_w + 1e-12)

    return fn


# ----------------------------------------------------------------------
# pointwise formulas
# ----------------------------------------------------------------------
@pointfn
def luma_rec601(r, gc, b):
    """ITU-R BT.601 luma from RGB planes."""
    return 0.299 * r + 0.587 * gc + 0.114 * b


def harris_response(k: float = 0.04):
    """Harris corner response over the windowed structure tensor."""
    @pointfn
    def response(a, c, b):
        return (a * c - b * b) - k * (a + c) * (a + c)

    return response


@pointfn
def lam_min(a, c, b):
    """Smaller eigenvalue of the 2x2 structure tensor (Shi-Tomasi)."""
    tr2 = (a + c) * 0.5
    det = a * c - b * b
    return tr2 - torch.sqrt(torch.clamp(tr2 * tr2 - det, min=0.0) + 1e-12)


def lk_vx(eps: float = 1e-3):
    """Lucas-Kanade horizontal flow from the windowed moments."""
    @pointfn
    def vx(a, c, b, tx, ty):
        det = a * c - b * b
        return torch.where(torch.abs(det) > eps, (-c * tx + b * ty) / det,
                           0.0)

    return vx


def lk_vy(eps: float = 1e-3):
    """Lucas-Kanade vertical flow from the windowed moments."""
    @pointfn
    def vy(a, c, b, tx, ty):
        det = a * c - b * b
        return torch.where(torch.abs(det) > eps, (b * tx - a * ty) / det,
                           0.0)

    return vy
