"""Argument checks shared by the LM kernels' wrappers.

Each wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors; these helpers find the one device of a call, map element
types to the codes of ``csrc/lm_common.cuh`` and give the current
stream.  Anything a kernel does not take raises ``ValueError``.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["DTYPE_CODES", "call_device", "dtype_code", "stream_of",
           "sm_count"]

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
