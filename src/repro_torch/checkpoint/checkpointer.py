"""Async, atomic checkpoints in the reference's on-disk format (the port
of ``repro.checkpoint.checkpointer``).

Layout, as the reference writes it: one ``.npy`` per leaf, named by the
leaf's dotted key (``opt.master.blocks.mlp.wg.npy``), in a
``step_<n>.tmp-*`` directory renamed to ``step_<n>/`` when complete,
with ``manifest.json`` (step, wall time, each leaf's file, shape, dtype
and crc32, the tree structure, the sorted keys).  bfloat16 leaves are
stored as their raw uint16 bits with dtype ``"bfloat16"`` in the
manifest, read and written through an int16 view of the tensor, so
neither JAX nor ``ml_dtypes`` is needed.  A checkpoint written by either
package restores in the other, bit for bit.

- **async**: ``Checkpointer.save`` copies every tensor to host memory on
  the calling thread (the reference's ``device_get``), then writes on a
  background thread; ``wait()`` joins.  A crashed write leaves no
  ``step_<n>/`` behind.
- **integrity**: crc32 per leaf, verified on restore.
- **retention**: the latest ``keep`` checkpoints stay.
- **elastic**: checkpoints carry no sharding.  A ``ShardedTensor`` leaf
  (:mod:`repro_torch.parallel.sharding`) is saved whole, and a restore
  with ``shardings=`` splits every leaf onto the current mesh, whatever
  mesh shape (or none) saved it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["Checkpointer", "save_pytree", "restore_pytree", "latest_step"]

_SEP = "."


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Dotted key -> leaf, keys in sorted order (``jax.tree`` order)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix
                            else str(k)))
    return out


def _treedef(tree: Any) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints a
    dict tree."""
    def walk(t):
        if not isinstance(t, dict):
            return "*"
        return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                               for k in sorted(t)) + "}"
    return f"PyTreeDef({walk(tree)})"


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array to store, the leaf's dtype name): a tensor copied to
    host memory (a sharded one put back together there), bfloat16 as its
    uint16 bits."""
    if hasattr(leaf, "gather") and hasattr(leaf, "sharding"):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):       # a copy: training goes on
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, by name
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> tuple[dict[str, tuple[np.ndarray, str]], str]:
    """Every leaf in host memory, and the tree's structure."""
    return ({k: _host(v) for k, v in _flatten(tree).items()},
            _treedef(tree))


def _write(snap, treedef: str, directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    manifest: dict[str, Any] = {"step": step, "time": time.time(),
                                "leaves": {}}
    for key, (store, dtype) in snap.items():
        fn = key.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), store)
        manifest["leaves"][key] = {
            "file": fn, "shape": list(store.shape), "dtype": dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(store).tobytes()),
        }
    manifest["treedef"] = treedef
    manifest["keys"] = sorted(snap)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save of a dict tree of tensors (or numpy
    arrays); returns the final directory."""
    return _write(*_snapshot(tree), directory, step)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_pytree(like: Any, directory: str, step: int | None = None,
                   device=None, verify: bool = True,
                   shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a dict tree of tensors,
    ``meta`` ones too): each leaf in its ``like`` leaf's type and shape,
    on ``device`` (default: each ``like`` leaf's device, the CPU for a
    ``meta`` one).  ``shardings`` (a tree of ``NamedSharding`` like
    ``like``, or one for every leaf) splits each leaf onto its mesh
    instead: an elastic restart on any mesh shape."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption in {key!r} "
                              f"(crc {crc} != {meta['crc32']})")
        leaves[key] = _tensor(arr, meta["dtype"])
    flat_like = _flatten(like)
    missing = set(flat_like) - set(leaves)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")

    flat_sh = (None if shardings is None or hasattr(shardings, "shard")
               else _flatten(shardings))

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(t[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k in sorted(t)}
        got = leaves[prefix]
        if tuple(got.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {prefix!r}: shape "
                             f"{tuple(got.shape)}, expected {tuple(t.shape)}")
        if shardings is not None:
            sh = shardings if hasattr(shardings, "shard") else flat_sh[prefix]
            return sh.shard(got.to(dtype=t.dtype))
        dev = (torch.device(device) if device is not None
               else t.device if t.device.type != "meta" else "cpu")
        return got.to(device=dev, dtype=t.dtype)
    return build(like, "")


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_") and ".tmp-" not in n]
    return max(steps) if steps else None


class Checkpointer:
    """Async wrapper with retention and preemption flushing."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, tree: Any, step: int, blocking: bool = False) -> None:
        """Copies ``tree`` to host memory now; writes it on a background
        thread (or here, with ``blocking``)."""
        self.wait()
        snap = _snapshot(tree)

        def work():
            try:
                _write(*snap, self.directory, step)
                self._retain()
            except BaseException as e:  # pragma: no cover
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like: Any, step: int | None = None,
                device=None, shardings: Any = None) -> Any:
        return restore_pytree(like, self.directory, step, device,
                              shardings=shardings)

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def _retain(self) -> None:
        steps = sorted(int(n.split("_")[1])
                       for n in os.listdir(self.directory)
                       if n.startswith("step_") and ".tmp-" not in n)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
