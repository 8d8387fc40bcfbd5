"""The replica mesh: a 1-D list of devices for data-parallel farms.

Port of :func:`repro.parallel.sharding.replica_mesh`.  The port has no
``jax.sharding.Mesh``; :class:`ReplicaMesh` plays its part for
replication (:mod:`repro_torch.parallel.replicate`), the compiler's
``compile_graph(mesh=)`` and the serving runtime's replicated
micro-batcher.  The logical-axis sharding rules of the reference module
are not ported yet (``ROADMAP.md`` A9).

One deliberate difference: an explicit ``devices=`` list may name one
device more than once.  A host with one card then runs k > 1 replicas
on it, each on its own rows, which is how the replicated paths are
exercised where only one card exists; the reference's meshes hold
distinct devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.device import resolve_device

__all__ = ["ReplicaMesh", "replica_mesh"]


@dataclasses.dataclass(frozen=True)
class ReplicaMesh:
    """A 1-D mesh: ``devices[j]`` runs replica ``j`` of axis
    ``axis_names[0]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("replica",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a ReplicaMesh has one axis, got "
                             f"{self.axis_names}")
        if not self.devices:
            raise ValueError("a ReplicaMesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a ReplicaMesh's devices must be of one type, "
                             f"got {sorted(map(str, self.devices))}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> number of replicas (as ``Mesh.shape``)."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def replica_mesh(n_replicas: int | None = None, axis: str = "replica",
                 devices: Sequence[Any] | None = None, *,
                 device: Any = None) -> ReplicaMesh:
    """A 1-D mesh of ``n_replicas`` devices.

    With ``devices`` given, the first ``n_replicas`` of them (all by
    default); a device may be named more than once.  Otherwise the
    device type of ``device`` decides (default ``cuda``, which must
    exist): on ``cuda`` every visible card, on ``cpu`` ``n_replicas``
    copies of the CPU (one by default).  Asking for more replicas than
    there are devices raises ``ValueError``.
    """
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [dev] * (n_replicas if n_replicas is not None else 1)
    k = n_replicas if n_replicas is not None else len(devs)
    if k < 1:
        raise ValueError(f"n_replicas must be >= 1, got {k}")
    if k > len(devs):
        raise ValueError(
            f"asked for {k} replicas but only {len(devs)} devices are "
            f"visible (pass devices= to place several replicas on one "
            f"device)")
    for d in devs[:k]:
        resolve_device(d)
    return ReplicaMesh(tuple(devs[:k]), (axis,))
