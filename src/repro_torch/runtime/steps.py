"""Step-function builders for serving (the port of
``repro.runtime.steps``, its prefill and decode part).

A step here is the model call itself, a plain function, as in the
reference, whose callers jit it: the port's callers capture the decode
step as a CUDA graph
(:class:`~repro_torch.runtime.compiled_step.CompiledStep`, in
``launch/serve.py``).  A ``mesh`` and the training step raise
:class:`~repro_torch.device.NotPortedError`.
"""
from __future__ import annotations

from repro_torch.device import NotPortedError
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step", "make_train_step"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotPortedError("mesh= (sharded serving) is not ported yet")


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """step(params, {"tokens": (B, S)}, cache) -> (logits (B, V), cache)."""
    _no_mesh(mesh)

    def prefill_step(params, batch, cache):
        return M.prefill(params, cfg, batch["tokens"], cache,
                         enc_embeds=batch.get("enc_embeds"),
                         extra_embeds=batch.get("extra_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """step(params, {"token": (B,)}, cache) -> (logits (B, V), cache)."""
    _no_mesh(mesh)

    def decode_step(params, batch, cache):
        return M.decode_step(params, cfg, batch["token"], cache)

    return decode_step


def make_train_step(*args, **kwargs):
    """The training path comes with a later slice."""
    raise NotPortedError("make_train_step (the training path) is not "
                         "ported yet")
