"""The Mamba2 SSD chunked scan: the Hopper kernels and their wrapper.

Replaces the TPU kernel ``ssd_scan`` / ``_kernel``
(``src/repro/kernels/ssd_scan.py``) with hand-written CUDA kernels,
``csrc/ssd_scan.cu``.  Per chunk of ``chunk`` positions of one head the
function is the decay-masked product ``((C B^T) ⊙ exp(segsum(dt A)))
(x dt)``, plus the carried state's contribution, with the (P, N) float32
state carried across chunks; it returns y in x's type and the final
state.

What bounds it: operations (about 5.3 MFLOP per head and chunk at
mamba2-2.7b's widths, plus C B^T once per group and chunk).  The TPU
walks the chunks in order with the state in VMEM.  On the card one call
runs the chunk-parallel form of the same function in three passes
(:func:`plan` gives their grids and shared memory): a chunk pass, in
parallel over (batch, head, chunk, 32 columns of P), writes each
chunk's own end state, and in the same launch C B^T once per (batch,
group, chunk); a state pass, sequential over the chunks only, turns
those into each chunk's incoming state and the final state; an output
pass, in parallel over chunks again, forms y.  The products run on the
tensor cores in 3xTF32 (each float32 operand split into two TF32
parts, three products summed in float32), close to float32's accuracy.
The three launches count as one in ``ssd_scan.launches``.

Unlike the Pallas route, the kernels take any sequence length (a
ragged last chunk is masked as dt = 0 padding would act) and an
``init_state``.  :func:`ssd_scan` launches them for CUDA tensors and
runs the plain version (:func:`repro_torch.kernels.ref.ssd_ref`) for
CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import call_device, dtype_code, stream_of
from repro_torch.kernels.ref import ssd_ref

__all__ = ["ssd_scan", "ScanPlan", "plan", "smem_bytes", "MAX_CHUNK",
           "BLOCK_P", "SMEM_LIMIT"]

#: the longest chunk the kernel takes
MAX_CHUNK = 128
#: columns of P per block of the chunk and output passes
BLOCK_P = 32
#: rows and columns of a C B^T tile (csrc/ssd_scan.cu's kCB)
_CB_TILE = 64
#: threads of a state-pass block, each one float4 of the state
_STATE_THREADS = 256
#: dynamic shared memory a block may use on Hopper
SMEM_LIMIT = 232_448

_SOURCE = build.CudaSource("ssd_scan")
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One call's three launches: the chunk pass's blocks (C B^T tiles
    first, then one per batch, head, chunk and P tile), the state pass's
    and the output pass's; each pass's shared memory a block, bytes;
    the float32 scratch (C B^T, the chunk states, each chunk's summed
    dt A)."""
    chunks: int
    p_tiles: int
    cb_blocks: int
    chunk_blocks: int
    state_blocks: int
    output_blocks: int
    smem: tuple[int, int, int]
    scratch_floats: int


def _pass_smem(chunk: int, n: int) -> tuple[int, int, int]:
    """Shared bytes of a chunk-pass, state-pass and output-pass block
    (``pass1_floats`` / ``pass3_floats`` in the source): float32 tiles
    with chunk and n rounded up to 8, rows padded to 8 (k-major) or 4
    (row-major) words past a multiple of 32."""
    L8, n8 = -(-chunk // 8) * 8, -(-n // 8) * 8

    def kstride(v):
        return -(-v // 32) * 32 + 8

    def rstride(v):
        return -(-v // 32) * 32 + 4
    pass1 = max(L8 * kstride(BLOCK_P) + L8 * kstride(n8) + 2 * L8,
                2 * _CB_TILE * rstride(n8))
    pass3 = max((L8 + BLOCK_P) * rstride(n8),
                L8 * (kstride(L8) + kstride(BLOCK_P))) + L8
    return 4 * pass1, 0, 4 * pass3


def smem_bytes(chunk: int, n: int) -> int:
    """The most shared memory a block of the three passes needs."""
    return max(_pass_smem(chunk, n))


def plan(b: int, s: int, h: int, p: int, g: int, n: int,
         chunk: int) -> ScanPlan:
    nc = -(-s // chunk)
    nps = -(-p // BLOCK_P)
    tiles = -(-chunk // _CB_TILE)
    cb_blocks = b * g * nc * tiles * (tiles + 1) // 2
    return ScanPlan(
        chunks=nc, p_tiles=nps, cb_blocks=cb_blocks,
        chunk_blocks=cb_blocks + b * h * nc * nps,
        state_blocks=b * h * -(-(p * n // 4) // _STATE_THREADS),
        output_blocks=b * h * nc * nps, smem=_pass_smem(chunk, n),
        scratch_floats=(b * g * nc * chunk * chunk + b * h * nc * p * n
                        + b * h * nc))


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
        if init_state.data_ptr() % 16:      # read as float4
            init_state = init_state.clone()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if s == 0 or y.numel() == 0:
        final = (torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device)
                 if init_state is None else init_state.clone())
        return y, final
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan(b, s, h, p, g, n, chunk).scratch_floats,
                          dtype=torch.float32, device=x.device)
    vec = p % 4 == 0 and all(_rows_aligned(t) for t in (x, B, C))
    dims = (ctypes.c_int * 8)(b, s, h, p, g, n, chunk, int(vec))
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        *y.stride()[:3])
    fn = _SOURCE.function("ssd_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(),
                None if init_state is None else init_state.data_ptr(),
                y.data_ptr(), final.data_ptr(), scratch.data_ptr(), code,
                dims, strides,
                stream_of(x.device))
    _SOURCE.check(rc)
    return y, final


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` starts on a multiple of 4 elements in
    memory (16 bytes in float32, 8 in bf16): with p a multiple of 4 the
    kernels then read 4 elements a load."""
    return (t.data_ptr() % (4 * t.element_size()) == 0
            and all(st % 4 == 0 for st in t.stride()[:-1]))
