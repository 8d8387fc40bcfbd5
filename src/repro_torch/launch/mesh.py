"""Mesh construction (the port of :mod:`repro.launch.mesh`).

Functions, not module constants, as in the reference: importing this
module touches no device.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import (Mesh, make_mesh, resident_bytes)

__all__ = ["make_production_mesh", "make_local_mesh", "launch_mesh",
           "bytes_per_device"]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence[Any] | None = None,
                         device: Any = None) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512).

    Axes: ``pod`` (DP across pods), ``data`` (DP/FSDP), ``model``
    (TP/EP/SP).  Over ``devices`` or the visible devices of ``device``'s
    type (default ``cuda``); fewer than the mesh needs raises
    ``ValueError``, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices, device=device)


def make_local_mesh(data: int = 1, model: int = 1,
                    devices: Sequence[Any] | None = None,
                    device: Any = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (which may name one device
    several times: a 2 x 2 mesh on one card or on the CPU) or the
    visible devices of ``device``'s type (default ``cuda``)."""
    return make_mesh((data, model), ("data", "model"), devices,
                     device=device)


def launch_mesh(data: int, model: int, device: Any = None) -> Mesh:
    """The launchers' (data, model) mesh over the visible cards of
    ``device``'s type (default ``cuda``): one card a position where there
    are enough, else the mesh's rows dealt out to the cards in turn (one
    card, or the CPU, then holds the whole mesh)."""
    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    n = data * model
    devices = (visible[:n] if len(visible) >= n else
               [visible[(i // model) % len(visible)] for i in range(n)])
    return make_local_mesh(data, model, devices=devices)


def bytes_per_device(mesh: Mesh, shardings: Any, like: Any
                     ) -> dict[torch.device, int]:
    """The bytes each distinct device of ``mesh`` holds of a tree split
    by ``shardings`` (``like``: the leaves' shapes and types): the sum
    over the positions it stands at."""
    per_pos = resident_bytes(shardings, like)
    out: dict[torch.device, int] = {}
    for pos in np.ndindex(per_pos.shape):
        d = mesh.devices[pos]
        out[d] = out.get(d, 0) + int(per_pos[pos])
    return out
