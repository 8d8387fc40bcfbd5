"""Persistent tuning cache: measured schedule configs, on disk.

Port of :mod:`repro.tune.store`.  Profiling lowered candidates on the
card costs real time (an nvcc build and a timed launch each), so the
winning :class:`ScheduleConfig` is persisted under a :class:`TuningKey`
of ``(DataflowGraph.signature(), backend, device kind, input shapes,
mode, context)`` and every later ``compile_graph(..., tune="auto")`` of
the same app on the same card loads it with **zero** re-measurement.

Layout: one JSON file per key under the cache root (``root`` argument,
else ``$REPRO_TUNE_CACHE``, else ``~/.cache/repro_torch/tune``).
Writes are atomic (temp file + ``os.replace``) so concurrent tuners
never expose a torn record; records are versioned so a format change
invalidates old entries instead of misreading them.

    >>> import tempfile
    >>> cache = TuningCache(tempfile.mkdtemp())
    >>> key = TuningKey("sig0123", "cuda_stream", "cpu",
    ...                 (("img", (8, 128), "float32"),))
    >>> cfg = ScheduleConfig(group_vf=(2,))
    >>> cache.put(key, TuningRecord(config=cfg, source="measured"))
    >>> cache.get(key).config.group_vf
    (2,)
    >>> len(TuningCache(cache.root))      # a fresh handle re-reads disk
    1
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Iterator

__all__ = ["ScheduleConfig", "TuningKey", "TuningRecord", "TuningCache",
           "default_cache_root", "detect_device_kind", "device_mode",
           "RECORD_VERSION"]

#: bump when the record format changes; readers skip other versions
RECORD_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """One point of the schedule search space, ready to re-apply.

    The three knobs the tuner searches:

    - ``group_vf`` — per-fusion-group vector factor (tile width
      ``32 * vf``), aligned with ``Schedule.groups`` order (``None`` for
      trivial custom/reduce groups, which have no tile); the model picks
      each group's height at that width;
    - ``max_tile`` — the tile-shape cap handed to the tile selection
      (the height axis of the search);
    - ``vmem_fraction`` — the fusion budget: the fraction of the card's
      shared memory per block the partitioner and the tile sweep may
      spend (:func:`repro_torch.core.vectorize.scale_spec`; the
      reference's name for its VMEM budget is kept), which changes
      *which stages fuse*, not just how they tile.
    """

    group_vf: tuple[int | None, ...]
    max_tile: tuple[int, int] = (64, 256)
    vmem_fraction: float = 1.0

    def to_json(self) -> dict[str, Any]:
        return {"group_vf": list(self.group_vf),
                "max_tile": list(self.max_tile),
                "vmem_fraction": self.vmem_fraction}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ScheduleConfig":
        return cls(group_vf=tuple(d["group_vf"]),
                   max_tile=tuple(d["max_tile"]),
                   vmem_fraction=float(d["vmem_fraction"]))

    def describe(self) -> str:
        vfs = ",".join("-" if v is None else str(v) for v in self.group_vf)
        return (f"vf=[{vfs}] max_tile={self.max_tile} "
                f"vmem_fraction={self.vmem_fraction:g}")


def device_mode(device) -> str:
    """The key's ``mode`` for an app's device: ``"compiled"`` for a
    CUDA device (the kernels timed on the card), ``"plain"`` otherwise
    (the plain versions timed on the CPU) — the port of the reference's
    interpret/compiled split."""
    import torch
    return "compiled" if torch.device(device).type == "cuda" else "plain"


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """Identity of a tuning result: graph x backend x hardware x shapes.

    ``signature`` is :meth:`repro_torch.core.graph.DataflowGraph.signature`;
    ``shapes`` repeats the graph-input shapes so a record survives a
    signature-algorithm change detectably rather than silently.
    ``device_kind`` is the card's name (``detect_device_kind``) and
    ``mode`` separates timings of the kernels on the card
    (``"compiled"``) from timings of the plain versions on the CPU
    (``"plain"``): a record measured on the CPU never serves the card.
    ``context`` digests everything else that changes what a measurement
    means (the spec's constants, strict/canonicalize compile flags).
    ``backend`` is the resolved record's
    :meth:`~repro_torch.backends.Backend.cache_key`, so a calibrated
    backend keeps its own records.
    """

    signature: str
    backend: str
    device_kind: str
    shapes: tuple[tuple[str, tuple[int, ...], str], ...]
    mode: str = "compiled"
    context: str = ""

    @classmethod
    def for_graph(cls, graph, backend, device_kind: str | None = None, *,
                  mode: str = "compiled", context: str = "") -> "TuningKey":
        from repro_torch.backends import resolve
        from repro_torch.core.graph import dtype_name
        if device_kind is None:
            device_kind = detect_device_kind()
        shapes = tuple((c.name, tuple(c.shape), dtype_name(c.dtype))
                       for c in graph.graph_inputs)
        return cls(graph.signature(), resolve(backend).cache_key(),
                   device_kind, shapes, mode, context)

    def digest(self) -> str:
        blob = json.dumps([self.signature, self.backend, self.device_kind,
                           [list(map(str, s)) for s in self.shapes],
                           self.mode, self.context])
        return hashlib.sha256(blob.encode()).hexdigest()[:24]


@dataclasses.dataclass
class TuningRecord:
    """A stored tuning result plus enough context to audit it."""

    config: ScheduleConfig
    #: how the config was obtained ("measured"); a *loaded* record is
    #: reported as source="cache" by the search layer
    source: str = "measured"
    best_measured_s: float | None = None
    analytic_measured_s: float | None = None
    modeled_s: float | None = None
    n_trials: int = 0
    #: candidates the calibrated prior skipped without measuring
    n_pruned: int = 0
    created_at: float = 0.0
    version: int = RECORD_VERSION

    def to_json(self, key: TuningKey) -> dict[str, Any]:
        return {"version": self.version,
                "key": {"signature": key.signature, "backend": key.backend,
                        "device_kind": key.device_kind, "mode": key.mode,
                        "context": key.context,
                        "shapes": [[n, list(s), d] for n, s, d in key.shapes]},
                "config": self.config.to_json(), "source": self.source,
                "best_measured_s": self.best_measured_s,
                "analytic_measured_s": self.analytic_measured_s,
                "modeled_s": self.modeled_s, "n_trials": self.n_trials,
                "n_pruned": self.n_pruned,
                "created_at": self.created_at}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "TuningRecord":
        return cls(config=ScheduleConfig.from_json(d["config"]),
                   source=d.get("source", "measured"),
                   best_measured_s=d.get("best_measured_s"),
                   analytic_measured_s=d.get("analytic_measured_s"),
                   modeled_s=d.get("modeled_s"),
                   n_trials=int(d.get("n_trials", 0)),
                   n_pruned=int(d.get("n_pruned", 0)),
                   created_at=float(d.get("created_at", 0.0)),
                   version=int(d.get("version", 0)))


def default_cache_root() -> str:
    """Resolve the on-disk root: ``$REPRO_TUNE_CACHE`` else XDG cache.

    The port keeps its own directory (``repro_torch/tune``) beside the
    reference's: its cost model and its measurements are the card's,
    not the TPU's.
    """
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME",
                         os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(xdg, "repro_torch", "tune")


def detect_device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA
    ``device`` (default: the current card), else the device type
    (``"cpu"`` on a host without a card)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return "cpu" if dev.type == "cuda" else dev.type


def write_json_atomic(root: str, path: str, payload: str) -> None:
    """Write ``payload`` to ``path`` (inside ``root``) through a temp
    file and ``os.replace``: readers never see a torn file."""
    os.makedirs(root, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def remove_json_files(root: str) -> None:
    """Delete every ``*.json`` directly under ``root`` (missing: no-op)."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for n in names:
        if n.endswith(".json"):
            try:
                os.unlink(os.path.join(root, n))
            except OSError:
                pass


class TuningCache:
    """On-disk store of measured :class:`ScheduleConfig` winners.

    ``get``/``put`` are keyed by :class:`TuningKey`; a process-local
    memo sits in front of the filesystem so the serving engine's many
    per-request ``compile_graph(tune="auto")`` calls do not re-read
    JSON.  ``put`` accepts ``aliases`` — extra keys mapping to the same
    record — because canonicalization can change a graph's signature
    once: both the pre- and post-canonicalization forms must hit.
    """

    def __init__(self, root: str | None = None):
        self.root = root or default_cache_root()
        self._memo: dict[str, TuningRecord | None] = {}
        self._lock = threading.Lock()

    def _path(self, key: TuningKey) -> str:
        return os.path.join(self.root, key.digest() + ".json")

    def get(self, key: TuningKey) -> TuningRecord | None:
        """Load the record for ``key`` (memoized), or ``None`` on miss."""
        digest = key.digest()
        with self._lock:
            if digest in self._memo:
                return self._memo[digest]
        rec: TuningRecord | None = None
        try:
            with open(self._path(key)) as f:
                raw = json.load(f)
            if raw.get("version") == RECORD_VERSION:
                rec = TuningRecord.from_json(raw)
        except (OSError, ValueError, KeyError):
            rec = None
        with self._lock:
            self._memo[digest] = rec
        return rec

    def put(self, key: TuningKey, record: TuningRecord,
            aliases: tuple[TuningKey, ...] = ()) -> None:
        """Persist ``record`` under ``key`` (and ``aliases``) atomically."""
        if not record.created_at:
            record.created_at = time.time()
        for k in (key, *aliases):
            write_json_atomic(self.root, self._path(k),
                              json.dumps(record.to_json(k), indent=1))
            with self._lock:
                self._memo[k.digest()] = record

    def invalidate(self, key: TuningKey) -> None:
        with self._lock:
            self._memo.pop(key.digest(), None)
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def clear(self) -> None:
        with self._lock:
            self._memo.clear()
        remove_json_files(self.root)

    def entries(self) -> Iterator[TuningRecord]:
        """Yield every readable current-version record on disk; alias
        files (the pre/post-canonicalization forms of one result) are
        deduplicated — one tuned app counts once."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        seen: list[TuningRecord] = []
        for n in names:
            if not n.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, n)) as f:
                    raw = json.load(f)
                if raw.get("version") != RECORD_VERSION:
                    continue
                rec = TuningRecord.from_json(raw)
            except (OSError, ValueError, KeyError):
                continue
            if rec in seen:                 # an alias of a yielded record
                continue
            seen.append(rec)
            yield rec

    def __len__(self) -> int:
        return sum(1 for _ in self.entries())
