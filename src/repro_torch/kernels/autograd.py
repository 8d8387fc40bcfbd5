"""Gradients through the LM kernels on the training path.

The kernels' wrappers call the CUDA code through ctypes and return
fresh tensors with no ``grad_fn``: a loss computed through them would
give no gradient to anything behind a kernel (the MLP's weights, the
projections that feed q, k and v, the SSM's inputs), silently.  Each
kernel on the training forward therefore gets a
``torch.autograd.Function``:

- ``forward`` launches the hand-written kernel through its wrapper,
  which counts the launch as it always does;
- ``backward`` recomputes the plain version
  (:mod:`repro_torch.kernels.ref`) from the saved inputs under
  ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it for
  every input that needs one, adding one to the wrapper's
  ``backward_calls``.

The MLP's backward departs from that for bf16 inputs:
:class:`FusedMlpFn` then takes
:func:`~repro_torch.kernels.fused_mlp_backward.fused_mlp_backward`
(products on the tensor cores with float32 sums, SwiGLU's backward in
one hand-written kernel) and adds one to ``tc_backward_calls`` as well.
That is no departure from the configuration: a bf16 model keeps its
weights and activations in bf16 (``bench/configs/granite-3-2b.json``),
so dy and the weights enter the products exactly; the backward adds
roundings of hb and ab, which the forward's tensor-core route rounds
too, and of dg and du, once each.  Float32 and float64 keep the plain
recompute, which ``torch.autograd.gradcheck`` holds exactly.

The JAX package has no backward kernel either: its ``jax.grad``
differentiates whatever ``impl`` resolves to, the plain versions off
the TPU.  Recomputing from the saved inputs is what the reference's
``remat`` does too.  :mod:`repro_torch.kernels.ops` takes these
Functions only when the kernel runs, grad mode is on and some input
requires a gradient; serving calls the kernels as before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (flash_attention as
                                                 _flash_kernel)
from repro_torch.kernels.fused_mlp import fused_mlp as _mlp_kernel
from repro_torch.kernels.fused_mlp_backward import fused_mlp_backward
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

__all__ = ["FlashAttentionFn", "FusedMlpFn", "SsdScanFn", "needs_grad"]

#: the plain backward's calls, one per Function backward
_flash_kernel.backward_calls = 0
_mlp_kernel.backward_calls = 0
_ssd_kernel.backward_calls = 0
#: the MLP's backward calls that took the tensor-core route (bf16)
_mlp_kernel.tc_backward_calls = 0


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether a call on ``tensors`` is recorded for a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _plain_grads(fn, inputs, outputs_grads) -> tuple:
    """``torch.autograd.grad`` of ``fn(*detached inputs)`` for each input
    whose slot needs one (None elsewhere).  ``outputs_grads`` pairs each
    output with its incoming gradient; pairs whose gradient is None are
    dropped."""
    leaves = [None if t is None else t.detach().requires_grad_(want)
              for t, want in inputs]
    with torch.enable_grad():
        outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, outputs_grads) if g is not None]
    wanted = [t for t, (_, want) in zip(leaves, inputs) if want]
    if not pairs or not wanted:
        return tuple(None for _ in inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return tuple(next(got) if want else None for _, want in inputs)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention(q, k, v, bias, causal, scale)``: the kernel
    forward, the plain version's gradients for q, k, v and bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, bias)
        return _flash_kernel(q, k, v, bias=bias, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        _flash_kernel.backward_calls += 1
        want = ctx.needs_input_grad[:4]
        grads = _plain_grads(
            lambda q, k, v, bias: _ref.flash_attention_ref(
                q, k, v, bias=bias, causal=ctx.causal, scale=ctx.scale),
            list(zip((q, k, v, bias), want)), (g,))
        return (*grads, None, None)


class FusedMlpFn(torch.autograd.Function):
    """``fused_mlp(x, w_norm, w_gate, w_up, w_down, eps)``: the kernel
    forward; the gradients for x and the four weights from
    ``fused_mlp_backward`` for bf16 inputs, else the plain version's."""

    @staticmethod
    def forward(ctx, x, w_norm, w_gate, w_up, w_down, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w_norm, w_gate, w_up, w_down)
        return _mlp_kernel(x, w_norm, w_gate, w_up, w_down, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:5]
        _mlp_kernel.backward_calls += 1
        if saved[0].dtype == torch.bfloat16:
            _mlp_kernel.tc_backward_calls += 1
            return (*fused_mlp_backward(*saved, g, ctx.eps, want), None)
        grads = _plain_grads(
            lambda *a: _ref.fused_mlp_ref(*a, eps=ctx.eps),
            list(zip(saved, want)), (g,))
        return (*grads, None)


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan(x, dt, A, B, C, chunk, init_state)`` -> (y, final
    state): the kernel forward, the plain version's gradients for x, dt,
    A, B, C and init_state.  Training uses y only; a gradient reaching
    the final state is taken into the same recomputation."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, init_state):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        return _ssd_kernel(x, dt, A, B, C, chunk=chunk,
                           init_state=init_state)

    @staticmethod
    def backward(ctx, gy, gfinal):
        x, dt, A, B, C, init = ctx.saved_tensors
        _ssd_kernel.backward_calls += 1
        want = ctx.needs_input_grad
        inputs = list(zip((x, dt, A, B, C, init),
                          want[:5] + (want[6],)))
        grads = _plain_grads(
            lambda x, dt, A, B, C, init: _ref.ssd_ref(
                x, dt, A, B, C, chunk=ctx.chunk, init_state=init),
            inputs, (gy, gfinal))
        return (*grads[:5], None, grads[5])
