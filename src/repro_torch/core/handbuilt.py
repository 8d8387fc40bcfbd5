"""Hand-built Table-I graphs: the equivalence oracle for the frontend.

Port of :mod:`repro.core.handbuilt` (``ROADMAP.md`` A2), over the
port's :mod:`repro_torch.frontend.lib`.

These are the stage-DSL app builders — explicit channels, explicit
``split`` stages, hand-picked stage names — kept as the ground truth
the traced single-source builders in :mod:`repro_torch.core.apps` are
checked against: the test-suite asserts that every traced app's
canonicalized :meth:`~repro_torch.core.graph.DataflowGraph.signature`
equals its hand-built twin's, and that outputs agree bit-exactly
(atol=0) on every backend.

Two deliberate adaptations from the pre-frontend builders (semantics
are unchanged; the graphs here are *not* verbatim git history):

- Stage *functions* come from the shared kernel library
  (:mod:`repro_torch.frontend.lib`) instead of inline lambdas — the same
  objects the tracer records — because signature equality hashes
  stage bodies, and because each coefficient table and pointwise
  formula should exist exactly once.
- ``unsharp_mask`` expresses ``a + amount * d`` as two canonical
  stages (``amplify`` = scale, ``sharpen`` = add) rather than one
  fused lambda, mirroring how operator tracing records it; point
  fusion collapses both forms to the same canonical graph.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.graph import DataflowGraph
from repro_torch.frontend.lib import (GAUSS3, GAUSS5, JACOBI3, LAPLACE3,
                                      MEAN5, SOBEL_X, SOBEL_Y, add, bilateral,
                                      conv_taps, harris_response, lam_min,
                                      lk_vx, lk_vy, luma_rec601, mul, scale,
                                      sobel_mag, square, sub)

__all__ = ["HAND_BUILT"]


def mean_filter(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("mean_filter")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (5, 5), conv_taps(MEAN5), name="mean5"), "out")
    return g


def gaussian_blur(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("gaussian_blur")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (5, 5), conv_taps(GAUSS5), name="gauss5"), "out")
    return g


def bilateral_filter(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("bilateral_filter")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (5, 5), bilateral(), name="bilateral5",
                       ii=4.0, fill=64.0), "out")
    return g


def sobel_luma(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("sobel_luma")
    r = g.input("r", (h, w))
    gr = g.input("g", (h, w))
    b = g.input("b", (h, w))
    luma = g.pointn([r, gr, b], luma_rec601.fn, name="luma")
    g.output(g.stencil(luma, (3, 3), sobel_mag, name="sobel"), "out")
    return g


def unsharp_mask(h: int, w: int, amount: float = 1.5) -> DataflowGraph:
    g = DataflowGraph("unsharp_mask")
    x = g.input("img", (h, w))
    x1, x2, x3 = g.split(x, 3)
    blur = g.stencil(x1, (5, 5), conv_taps(GAUSS5), name="blur")
    diff = g.point2(x2, blur, sub, name="highpass")
    amp = g.point(diff, scale(amount), name="amplify")
    g.output(g.point2(x3, amp, add, name="sharpen"), "out")
    return g


def filter_chain(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("filter_chain")
    x = g.input("img", (h, w))
    c = x
    for i in range(3):
        c = g.stencil(c, (3, 3), conv_taps(GAUSS3), name=f"filt{i + 1}")
    g.output(c, "out")
    return g


def jacobi(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("jacobi")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (3, 3), conv_taps(JACOBI3), name="jacobi3"), "out")
    return g


def laplace(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("laplace")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (3, 3), conv_taps(LAPLACE3), name="laplace3"),
             "out")
    return g


def square_app(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("square")
    x = g.input("img", (h, w))
    g.output(g.point(x, square, name="square"), "out")
    return g


def sobel(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("sobel")
    x = g.input("img", (h, w))
    g.output(g.stencil(x, (3, 3), sobel_mag, name="sobel3"), "out")
    return g


def harris(h: int, w: int, k: float = 0.04) -> DataflowGraph:
    g = DataflowGraph("harris")
    x = g.input("img", (h, w))
    x1, x2 = g.split(x, 2)
    ix = g.stencil(x1, (3, 3), conv_taps(SOBEL_X), name="Ix")
    iy = g.stencil(x2, (3, 3), conv_taps(SOBEL_Y), name="Iy")
    ixa, ixb = g.split(ix, 2, name="splitIx")
    iya, iyb = g.split(iy, 2, name="splitIy")
    ixx = g.point(ixa, square, name="Ixx")
    iyy = g.point(iya, square, name="Iyy")
    ixy = g.point2(ixb, iyb, mul, name="Ixy")
    wxx = g.stencil(ixx, (5, 5), conv_taps(GAUSS5), name="WIxx")
    wyy = g.stencil(iyy, (5, 5), conv_taps(GAUSS5), name="WIyy")
    wxy = g.stencil(ixy, (5, 5), conv_taps(GAUSS5), name="WIxy")
    resp = g.pointn([wxx, wyy, wxy], harris_response(k).fn, name="response")
    g.output(resp, "out")
    return g


def shi_tomasi(h: int, w: int) -> DataflowGraph:
    g = DataflowGraph("shi_tomasi")
    x = g.input("img", (h, w))
    x1, x2 = g.split(x, 2)
    ix = g.stencil(x1, (3, 3), conv_taps(SOBEL_X), name="Ix")
    iy = g.stencil(x2, (3, 3), conv_taps(SOBEL_Y), name="Iy")
    ixa, ixb = g.split(ix, 2, name="splitIx")
    iya, iyb = g.split(iy, 2, name="splitIy")
    ixx = g.point(ixa, square, name="Ixx")
    iyy = g.point(iya, square, name="Iyy")
    ixy = g.point2(ixb, iyb, mul, name="Ixy")
    wxx = g.stencil(ixx, (5, 5), conv_taps(GAUSS5), name="WIxx")
    wyy = g.stencil(iyy, (5, 5), conv_taps(GAUSS5), name="WIyy")
    wxy = g.stencil(ixy, (5, 5), conv_taps(GAUSS5), name="WIxy")
    g.output(g.pointn([wxx, wyy, wxy], lam_min.fn, name="score"), "out")
    return g


def optical_flow_lk(h: int, w: int, eps: float = 1e-3) -> DataflowGraph:
    """Lucas-Kanade optical flow (paper Fig. 4): 16 compute stages."""
    g = DataflowGraph("optical_flow_lk")
    f1 = g.input("f1", (h, w))
    f2 = g.input("f2", (h, w))
    f1a, f1b, f1c = g.split(f1, 3, name="split_f1")
    # normalized derivative taps (sobel/8 ~= centered difference)
    ix = g.stencil(f1a, (3, 3), conv_taps(SOBEL_X / 8.0), name="Ix")   # 1
    iy = g.stencil(f1b, (3, 3), conv_taps(SOBEL_Y / 8.0), name="Iy")   # 2
    it = g.point2(f2, f1c, sub, name="It")                             # 3
    ix1, ix2, ix3 = g.split(ix, 3, name="split_Ix")
    iy1, iy2, iy3 = g.split(iy, 3, name="split_Iy")
    it1, it2 = g.split(it, 2, name="split_It")
    ixx = g.point(ix1, square, name="IxIx")                            # 4
    iyy = g.point(iy1, square, name="IyIy")                            # 5
    ixy = g.point2(ix2, iy2, mul, name="IxIy")                         # 6
    ixt = g.point2(ix3, it1, mul, name="IxIt")                         # 7
    iyt = g.point2(iy3, it2, mul, name="IyIt")                         # 8
    wxx = g.stencil(ixx, (5, 5), conv_taps(GAUSS5), name="WIxx")       # 9
    wyy = g.stencil(iyy, (5, 5), conv_taps(GAUSS5), name="WIyy")       # 10
    wxy = g.stencil(ixy, (5, 5), conv_taps(GAUSS5), name="WIxy")       # 11
    wxt = g.stencil(ixt, (5, 5), conv_taps(GAUSS5), name="WIxt")       # 12
    wyt = g.stencil(iyt, (5, 5), conv_taps(GAUSS5), name="WIyt")       # 13
    wxx1, wxx2 = g.split(wxx, 2)
    wyy1, wyy2 = g.split(wyy, 2)
    wxy1, wxy2 = g.split(wxy, 2)
    wxt1, wxt2 = g.split(wxt, 2)
    wyt1, wyt2 = g.split(wyt, 2)
    g.output(g.pointn([wxx1, wyy1, wxy1, wxt1, wyt1], lk_vx(eps).fn,  # 14
                      name="Vx"), "vx")
    g.output(g.pointn([wxx2, wyy2, wxy2, wxt2, wyt2], lk_vy(eps).fn,  # 15
                      name="Vy"), "vy")
    return g


#: name -> hand-built builder (the oracle twin of ``repro_torch.core.apps.APPS``)
HAND_BUILT: dict[str, Callable[..., DataflowGraph]] = {
    "mean_filter": mean_filter,
    "gaussian_blur": gaussian_blur,
    "bilateral_filter": bilateral_filter,
    "sobel_luma": sobel_luma,
    "unsharp_mask": unsharp_mask,
    "filter_chain": filter_chain,
    "jacobi": jacobi,
    "optical_flow_lk": optical_flow_lk,
    "harris": harris,
    "shi_tomasi": shi_tomasi,
    "laplace": laplace,
    "square": square_app,
    "sobel": sobel,
}
