"""Hand-written Hopper kernels of the port and their build.

``stream_group`` — the fused dataflow group kernel (replaces
``repro.core.fusion.lower_group_pallas``); ``expr`` — the expression
recorder that turns stage bodies into C; ``build`` — nvcc + ctypes.
"""
