"""FLOWER dataflow compiler on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of :mod:`repro`: the same compiler pipeline — trace a
plain array program into a dataflow graph, canonicalize, partition it
into convex fusion groups, lower each group — with one hand-written
CUDA kernel per fusion group in place of the TPU's Pallas kernel
(:mod:`repro_torch.kernels.stream_group`).  Module names mirror
:mod:`repro` so each port module's counterpart is easy to find.
Compiled apps are served by :class:`repro_torch.runtime.StreamEngine`,
which micro-batches requests into one launch per fusion group, and
observed through :mod:`repro_torch.obs`.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card, asking for ``"cuda"`` raises
:class:`~repro_torch.device.DeviceUnavailableError` and never falls
back to the CPU.
"""
