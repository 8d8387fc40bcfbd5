"""Argument checks shared by the LM kernels' wrappers.

Each wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; these helpers find the one device of a call, map element
types to the codes of ``csrc/lm_common.cuh`` and give the current
stream.  Anything a kernel does not take raises ``ValueError``.
:func:`f32_matmul` is the product with float32 sums that the MLP's
backward and the MoE experts hand to cuBLAS.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["DTYPE_CODES", "call_device", "dtype_code", "f32_matmul",
           "stream_of", "sm_count"]

#: element types the LM kernels take, and their codes in lm_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def call_device(kernel: str, *tensors: torch.Tensor | None) -> torch.device:
    """The one device of a call's tensors (``None`` entries skipped);
    it must be ``cuda`` or ``cpu``."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors must share one device, got "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    return dev


def dtype_code(kernel: str, name: str, t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{kernel}: {name} is {t.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    return code


def stream_of(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, 2-D (``mm``) or batched 3-D (``bmm``), with float32 sums and
    a float32 result, as the reference's ``preferred_element_type=
    float32``: bf16 operands keep their type on the card (``out_dtype``,
    so no bf16 split-K reduction); on the CPU, which has no such product,
    they are upcast, and a bf16 product is exact in float32, so the two
    differ only in the order of the sums.  ``out_dtype`` has no
    derivative: callers that train wrap it in a Function."""
    op = torch.mm if a.dim() == 2 else torch.bmm
    if a.is_cuda:
        return op(a, b, out_dtype=torch.float32)
    return op(a.to(torch.float32), b.to(torch.float32))
