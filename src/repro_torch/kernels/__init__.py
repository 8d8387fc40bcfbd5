"""Hand-written Hopper kernels of the port and their build.

``stream_group`` — the fused dataflow group kernel (replaces
``repro.core.fusion.lower_group_pallas``); ``stream_pipeline`` — a
chain of pointwise stages fused into one pass, and its staged baseline
(replaces ``repro.kernels.stream_pipeline``); ``expr`` — the expression
recorder that turns stage bodies into C; ``flash_attention``,
``decode_attention``, ``fused_mlp``, ``ssd_scan`` — the LM kernels
(replace the Pallas kernels of the same names), with their plain
versions in ``ref`` and the ``impl=`` dispatch in ``ops``; ``build`` —
nvcc + ctypes.
"""
