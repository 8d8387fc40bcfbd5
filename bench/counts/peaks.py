"""The published peaks of one NVIDIA H100 SXM, the yardstick of every
share of a roofline or of a peak that the benchmark reports.

Source: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
the full 700 W power limit.  The same constants are in the port's
``src/repro_torch/analysis/roofline.py`` (``H100_HW``: 989e12 FLOP/s,
3.35e12 B/s) and ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``BF16_OPS_PER_S``, ``FP32_OPS_PER_S``, ``TF32_OPS_PER_S``); they are
frozen here so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth
BF16_FLOPS = 989e12            # bf16 / fp16 tensor cores, dense
TF32_FLOPS = 495e12            # TF32 tensor cores, dense
FP32_FLOPS = 67e12             # float32 on the CUDA cores

#: products' peak by the type of their operands, as the configuration
#: states it (never by the route a kernel takes)
_BY_DTYPE = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
             "float32": FP32_FLOPS}


def flops_for(dtype: str) -> float:
    """The peak FLOP/s of products whose operands have type ``dtype``."""
    if dtype not in _BY_DTYPE:
        raise KeyError(f"no peak for operands of type {dtype!r}")
    return _BY_DTYPE[dtype]


def bound_s(n_bytes: float, n_flops: float, flops_per_s: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM bandwidth and the operations over their peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)
