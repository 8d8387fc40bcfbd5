"""The Mamba2 SSD chunked scan: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``ssd_scan`` / ``_kernel``
(``src/repro/kernels/ssd_scan.py``) with a hand-written CUDA kernel,
``csrc/ssd_scan.cu``.  Per chunk of ``chunk`` positions of one head it
computes the decay-masked product ``((C B^T) ⊙ exp(segsum(dt A))) (x dt)``,
adds the carried state's contribution, and updates the (P, N) float32
state; it returns y in x's type and the final state.

On the TPU the chunks are a sequential grid dimension and the state
lives in VMEM scratch between grid steps.  On the card blocks run in no
order, so one block walks all chunks of a head and keeps the state in
shared memory; at mamba2-2.7b's widths a block's float32 tiles fill
its 227 KB, so each block takes 32 columns of P (grid b * h *
ceil(P / 32)).  What bounds it: operations (about 7.4 MFLOP per head
and chunk at L = N = 128), run in float32 on the CUDA cores.

Unlike the Pallas route, the kernel takes any sequence length (a
ragged last chunk is masked as dt = 0 padding would act) and an
``init_state``.  :func:`ssd_scan` launches the kernel for CUDA tensors,
adding one to ``ssd_scan.launches``, and runs the plain version
(:func:`repro_torch.kernels.ref.ssd_ref`) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, dtype_code, stream_of
from repro_torch.kernels.ref import ssd_ref

__all__ = ["ssd_scan", "smem_bytes", "MAX_CHUNK", "BLOCK_P", "SMEM_LIMIT"]

#: the longest chunk the kernel takes
MAX_CHUNK = 128
#: columns of P per block
BLOCK_P = 32
#: dynamic shared memory a block may use on Hopper
SMEM_LIMIT = 232_448

_SOURCE = build.CudaSource("ssd_scan")
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]


def smem_bytes(chunk: int, n: int) -> int:
    """A block's shared memory: B^T and C^T, the masked product, x*dt,
    the state and the cumsum, in float32 (``smem_floats`` in the
    source)."""
    return 4 * (2 * n * (chunk + 1) + chunk * (chunk + 1) + chunk * BLOCK_P
                + BLOCK_P * (n + 1) + chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h) float32; A: (h,) float32; B, C:
    (b, s, g, n); init_state: (b, h, p, n) or None (zeros).  Returns
    (y (b, s, h, p) in x's type, final_state (b, h, p, n) float32).

    The kernel on the card, the plain version on the CPU.
    """
    dev = call_device("ssd_scan", x, dt, A, B, C, init_state)
    if dev.type == "cpu":
        return ssd_ref(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    out = _launch(x, dt, A, B, C, chunk, init_state)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0


def _launch(x, dt, A, B, C, chunk, init_state):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError("ssd_scan: x must be (b, s, h, p), dt (b, s, h), "
                         "A (h,) and B, C (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, g, n) or C.shape != B.shape
            or g == 0 or h % g):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not fit")
    if chunk % 4 or not 0 < chunk <= MAX_CHUNK or n % 4:
        raise ValueError(f"ssd_scan: chunk {chunk} (a multiple of 4, at "
                         f"most {MAX_CHUNK}) and n {n} (a multiple of 4) "
                         f"are not taken")
    if smem_bytes(chunk, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk} with n {n} needs "
                         f"{smem_bytes(chunk, n)} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype} and {A.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, B and C must share a type, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    code = dtype_code("ssd_scan", "x", x)
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name}'s last dim must be "
                             f"contiguous")
    A = A.contiguous()
    if init_state is not None:
        if tuple(init_state.shape) != (b, h, p, n):
            raise ValueError(f"ssd_scan: init_state must be ({b}, {h}, {p},"
                             f" {n}), got {tuple(init_state.shape)}")
        init_state = init_state.to(torch.float32).contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if s == 0 or y.numel() == 0:
        final = (torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device)
                 if init_state is None else init_state.clone())
        return y, final
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    dims = (ctypes.c_int * 7)(b, s, h, p, g, n, chunk)
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        *y.stride()[:3])
    fn = _SOURCE.function("ssd_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(),
                None if init_state is None else init_state.data_ptr(),
                y.data_ptr(), final.data_ptr(), code, dims, strides,
                stream_of(x.device))
    _SOURCE.check(rc)
    return y, final
