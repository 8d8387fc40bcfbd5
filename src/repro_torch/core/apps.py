"""The paper's benchmark applications (Table I), as single-source
traced programs.

Port of :mod:`repro.core.apps`: the same 13 builders, traced by
:mod:`repro_torch.frontend`; :func:`compile_app` defaults to the
``cuda_stream`` backend on the card.
"""
from __future__ import annotations

from typing import Callable

import repro_torch.frontend as fe
from repro_torch.core.graph import DataflowGraph
from repro_torch.frontend import lib
from repro_torch.frontend.lib import (GAUSS3, GAUSS5, JACOBI3, LAPLACE3,
                                      MEAN5, SOBEL_X, SOBEL_Y)

__all__ = ["APPS", "build_app", "compile_app"]


# ----------------------------------------------------------------------
# application builders (traced single-source programs)
# ----------------------------------------------------------------------
def mean_filter(h: int, w: int) -> DataflowGraph:
    def mean_filter_src(img):
        return fe.conv(img, MEAN5)

    return fe.trace(mean_filter_src, (h, w), name="mean_filter")


def gaussian_blur(h: int, w: int) -> DataflowGraph:
    def gaussian_blur_src(img):
        return fe.conv(img, GAUSS5)

    return fe.trace(gaussian_blur_src, (h, w), name="gaussian_blur")


def bilateral_filter(h: int, w: int) -> DataflowGraph:
    def bilateral_src(img):
        return fe.window(img, (5, 5), lib.bilateral(), ii=4.0, fill=64.0)

    return fe.trace(bilateral_src, (h, w), name="bilateral_filter")


def sobel_luma(h: int, w: int) -> DataflowGraph:
    def sobel_luma_src(r, g, b):
        luma = lib.luma_rec601(r, g, b)
        return fe.window(luma, (3, 3), lib.sobel_mag)

    return fe.trace(sobel_luma_src, (h, w), (h, w), (h, w),
                    name="sobel_luma")


def unsharp_mask(h: int, w: int, amount: float = 1.5) -> DataflowGraph:
    def unsharp_src(img):
        blur = fe.conv(img, GAUSS5)
        return img + amount * (img - blur)

    return fe.trace(unsharp_src, (h, w), name="unsharp_mask")


def filter_chain(h: int, w: int) -> DataflowGraph:
    def filter_chain_src(img):
        c = img
        for _ in range(3):
            c = fe.conv(c, GAUSS3)
        return c

    return fe.trace(filter_chain_src, (h, w), name="filter_chain")


def jacobi(h: int, w: int) -> DataflowGraph:
    def jacobi_src(img):
        return fe.conv(img, JACOBI3)

    return fe.trace(jacobi_src, (h, w), name="jacobi")


def laplace(h: int, w: int) -> DataflowGraph:
    def laplace_src(img):
        return fe.conv(img, LAPLACE3)

    return fe.trace(laplace_src, (h, w), name="laplace")


def square(h: int, w: int) -> DataflowGraph:
    def square_src(img):
        return img * img

    return fe.trace(square_src, (h, w), name="square")


def sobel(h: int, w: int) -> DataflowGraph:
    def sobel_src(img):
        return fe.window(img, (3, 3), lib.sobel_mag)

    return fe.trace(sobel_src, (h, w), name="sobel")


def harris(h: int, w: int, k: float = 0.04) -> DataflowGraph:
    def harris_src(img):
        ix = fe.conv(img, SOBEL_X)
        iy = fe.conv(img, SOBEL_Y)
        ixx = ix * ix
        iyy = iy * iy
        ixy = ix * iy
        wxx = fe.conv(ixx, GAUSS5)
        wyy = fe.conv(iyy, GAUSS5)
        wxy = fe.conv(ixy, GAUSS5)
        return lib.harris_response(k)(wxx, wyy, wxy)

    return fe.trace(harris_src, (h, w), name="harris")


def shi_tomasi(h: int, w: int) -> DataflowGraph:
    def shi_tomasi_src(img):
        ix = fe.conv(img, SOBEL_X)
        iy = fe.conv(img, SOBEL_Y)
        ixx = ix * ix
        iyy = iy * iy
        ixy = ix * iy
        wxx = fe.conv(ixx, GAUSS5)
        wyy = fe.conv(iyy, GAUSS5)
        wxy = fe.conv(ixy, GAUSS5)
        return lib.lam_min(wxx, wyy, wxy)

    return fe.trace(shi_tomasi_src, (h, w), name="shi_tomasi")


def optical_flow_lk(h: int, w: int, eps: float = 1e-3) -> DataflowGraph:
    """Lucas-Kanade optical flow (paper Fig. 4): 16 compute stages."""
    def optical_flow_lk_src(f1, f2):
        ix = fe.conv(f1, SOBEL_X / 8.0)   # sobel/8 ~= centered difference
        iy = fe.conv(f1, SOBEL_Y / 8.0)
        it = f2 - f1
        ixx = ix * ix
        iyy = iy * iy
        ixy = ix * iy
        ixt = ix * it
        iyt = iy * it
        wxx = fe.conv(ixx, GAUSS5)
        wyy = fe.conv(iyy, GAUSS5)
        wxy = fe.conv(ixy, GAUSS5)
        wxt = fe.conv(ixt, GAUSS5)
        wyt = fe.conv(iyt, GAUSS5)
        vx = lib.lk_vx(eps)(wxx, wyy, wxy, wxt, wyt)
        vy = lib.lk_vy(eps)(wxx, wyy, wxy, wxt, wyt)
        return {"vx": vx, "vy": vy}

    return fe.trace(optical_flow_lk_src, (h, w), (h, w),
                    name="optical_flow_lk")


#: name -> (builder, table-I stage count, n_inputs)
APPS: dict[str, tuple[Callable[..., DataflowGraph], int, int]] = {
    "mean_filter": (mean_filter, 1, 1),
    "gaussian_blur": (gaussian_blur, 1, 1),
    "bilateral_filter": (bilateral_filter, 1, 1),
    "sobel_luma": (sobel_luma, 2, 3),
    "unsharp_mask": (unsharp_mask, 3, 1),
    "filter_chain": (filter_chain, 3, 1),
    "jacobi": (jacobi, 1, 1),
    "optical_flow_lk": (optical_flow_lk, 16, 2),
    "harris": (harris, 9, 1),
    "shi_tomasi": (shi_tomasi, 9, 1),
    "laplace": (laplace, 1, 1),
    "square": (square, 1, 1),
    "sobel": (sobel, 1, 1),
}


def build_app(name: str, h: int = 1024, w: int = 1024) -> DataflowGraph:
    if name not in APPS:
        raise KeyError(f"unknown app {name!r}; choose from {sorted(APPS)}")
    return APPS[name][0](h, w)


def compile_app(name: str, h: int = 1024, w: int = 1024,
                backend="cuda_stream", **kw):
    """Build + compile a Table-I app through the full pass pipeline.

    ``backend`` and ``**kw`` (``device=``, ...) are forwarded verbatim
    to :func:`repro_torch.core.compiler.compile_graph`.
    """
    from repro_torch.core.compiler import compile_graph
    return compile_graph(build_app(name, h, w), backend=backend, **kw)
