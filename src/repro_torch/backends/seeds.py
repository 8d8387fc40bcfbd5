"""The port's seed backends.

- ``torch`` (the reference's ``xla``): each group's stages composed as
  torch ops on whole planes.
- ``torch_staged`` (the reference's ``xla_staged``): the same, with
  every stage output materialized as its own plane, split arms
  included — the AnyHLS-style baseline with a device-memory round trip
  per channel.
- ``cuda_stream`` (the reference's ``pallas``): one generated CUDA
  kernel per fusion group (:mod:`repro_torch.kernels.stream_group`);
  on CPU tensors its wrapper runs the plain version.

Trivial (custom/reduce) groups stay torch-composed on every backend,
as the reference does.  ``interpret=True`` lowers a ``cuda_stream``
group to its plain version (the ``torch`` lowering) on whatever device
its inputs lie.  Every seed serves tuning, timed by
:func:`repro_torch.tune.search.default_measure`, and replication
(:func:`repro_torch.parallel.replicate.replicate_app`).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.backends.registry import register
from repro_torch.backends.spec import Backend

__all__ = ["TORCH", "TORCH_STAGED", "CUDA_STREAM", "SEED_BACKENDS"]


def _lower_torch(group, *, valid_rows: tuple[int, int] | None,
                 staged: bool = False, interpret: bool = False) -> Callable:
    # ``interpret`` changes nothing here: these stages are already the
    # plain versions
    from repro_torch.core.fusion import lower_group_torch
    return lower_group_torch(group, staged=staged, valid_rows=valid_rows)


def _lower_torch_staged(group, **kw) -> Callable:
    return _lower_torch(group, staged=not group.is_trivial, **kw)


def _lower_cuda_stream(group, *, valid_rows: tuple[int, int] | None,
                       interpret: bool = False) -> Callable:
    from repro_torch.core.fusion import lower_group_kernel, lower_group_torch
    if group.is_trivial or interpret:
        return lower_group_torch(group, staged=False, valid_rows=valid_rows)
    return lower_group_kernel(group, valid_rows=valid_rows)


def _tuner_measure(graph, backend, config, **kw) -> float:
    """Lower under ``config`` and time it on the app's device
    (:func:`repro_torch.tune.search.default_measure`)."""
    from repro_torch.tune.search import default_measure
    return default_measure(graph, backend, config, **kw)


TORCH = register(Backend(
    name="torch",
    description="stages composed as torch ops on whole planes",
    lower=_lower_torch,
    capabilities=frozenset({"tuning", "replication"}),
    measure=_tuner_measure,
))

TORCH_STAGED = register(Backend(
    name="torch_staged",
    description="every stage output, split arms included, materialized "
                "as its own plane",
    lower=_lower_torch_staged,
    capabilities=frozenset({"tuning", "replication"}),
    measure=_tuner_measure,
))

CUDA_STREAM = register(Backend(
    name="cuda_stream",
    description="one generated CUDA kernel per fusion group (sm_90a)",
    lower=_lower_cuda_stream,
    capabilities=frozenset({"tuning", "replication"}),
    measure=_tuner_measure,
))

SEED_BACKENDS = ("torch", "torch_staged", "cuda_stream")
