"""Meshes and logical-axis sharding rules: DP / FSDP / TP / SP / EP on one
mesh (the port of :mod:`repro.parallel.sharding`).

Models carry *logical* axis names (declared next to every parameter in
``ParamDef.axes``); this module maps them onto the mesh's axes.  Divisibility-aware, as the reference: a
logical axis only binds to a mesh axis when the dimension divides evenly
(or, for an activation, the logical axis is ``uneven_ok``); otherwise it
is left unsharded and the decision is recorded in ``notes``.

The port has no ``jax.sharding``, so it carries its own:

- :class:`Mesh`: named axes over a numpy array of ``torch.device``s
  (``shape`` is axis name -> size, as ``jax.sharding.Mesh.shape``);
  :func:`make_mesh` builds one.  :class:`ReplicaMesh` (1-D, the
  replication plane's) stays as it was.
- :class:`PartitionSpec` (``P``) and :class:`NamedSharding`: which mesh
  axes split which dimension.  ``NamedSharding.shard`` splits a tensor
  into one contiguous copy per mesh position on that position's device
  (replicated dimensions are copied to every position);
  :class:`ShardedTensor` holds those pieces and ``gather`` puts them
  back together.

One controller drives every device of a mesh, as replication does.  A
mesh splits where state lives, not what is computed: the sharded steps
(:mod:`repro_torch.runtime.steps`) gather what a computation needs onto
the device that runs it, and the ``model`` axis splits memory, not
arithmetic.  So the port has no activation constraints (the reference's
``make_activation_fn`` / ``shard_act``): an activation lives on the
device of its data shard, whole.  ``spec_for_axes(allow_uneven=True)``
still gives the spec the reference would constrain it to.

Deliberate difference: an explicit ``devices=`` list may name one device
more than once (a host with one card then runs a 2 x 2 mesh on it, each
position holding its own pieces).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import traffic

__all__ = ["ReplicaMesh", "replica_mesh", "Mesh", "make_mesh",
           "PartitionSpec", "P", "NamedSharding", "ShardedTensor",
           "ShardingRules", "TRAIN_RULES", "SERVE_RULES", "mesh_axis_size",
           "spec_for_axes", "make_param_shardings", "shard_tree", "gather_tree", "resident_bytes"]


# ----------------------------------------------------------------------
# the replica mesh (replication, the serving plane)
# ----------------------------------------------------------------------
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


def _visible(device: Any) -> list[torch.device]:
    """Every visible device of ``device``'s type: each card on ``cuda``
    (default), the one host device otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


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
        devs = _visible(device)
        if devs[0].type != "cuda":
            devs = devs * (n_replicas if n_replicas is not None else 1)
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


# ----------------------------------------------------------------------
# the N-D mesh
# ----------------------------------------------------------------------
class Mesh:
    """Named axes over an array of devices: ``devices[i, j, ...]`` is the
    device of mesh position ``(i, j, ...)``, one index per axis of
    ``axis_names``.  A device may stand at several positions."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = torch.device(src[pos])
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs that many "
                             f"distinct axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in arr.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted({str(d) for d in arr.flat})}")
        arr.setflags(write=False)
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[tuple[int, ...]]:
        """Every mesh position, row-major."""
        return np.ndindex(self.devices.shape)

    @property
    def distinct_devices(self) -> list[torch.device]:
        """The devices of the mesh, each once, in position order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    @property
    def single_device(self) -> bool:
        """Whether every position is the same device (a repeated mesh)."""
        return len(self.distinct_devices) == 1

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.distinct_devices)
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[Any] | None = None, *,
              device: Any = None) -> Mesh:
    """A mesh of ``axis_shapes`` over the first prod(shape) of
    ``devices`` (a list that may name one device more than once), or of
    the visible devices of ``device``'s type (default ``cuda``, which
    must exist: every card; on the CPU the one host device).  Asking for
    more devices than that raises ``ValueError``, as ``jax.make_mesh``
    does."""
    shape = tuple(int(s) for s in axis_shapes)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _visible(device))
    n = math.prod(shape)
    if n > len(devs):
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} devices but only "
            f"{len(devs)} are {'given' if devices is not None else 'visible'}"
            f" (pass devices= naming one device several times to build it "
            f"on fewer)")
    for d in devs[:n]:
        resolve_device(d)
    return Mesh(np.array(devs[:n], dtype=object).reshape(shape), axis_names)


# ----------------------------------------------------------------------
# partition specs and named shardings
# ----------------------------------------------------------------------
AxisBinding = Any  # str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (unsplit), a mesh axis name, or a
    tuple of them (split over their product, the first outermost).
    Dimensions past the spec's length are unsplit."""

    def __new__(cls, *dims: AxisBinding):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _names(b: AxisBinding) -> tuple[str, ...]:
    if b is None:
        return ()
    return (b,) if isinstance(b, str) else tuple(b)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` over ``mesh``: how a tensor's dimensions split over the
    mesh's axes, and so which piece each mesh position holds."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        used: list[str] = []
        for b in self.spec:
            for n in _names(b):
                if n not in self.mesh.shape:
                    raise ValueError(f"{self.spec}: no mesh axis {n!r} in "
                                     f"{self.mesh.axis_names}")
                if n in used:
                    raise ValueError(f"{self.spec} uses mesh axis {n!r} "
                                     f"twice")
                used.append(n)

    def _dims(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the "
                             f"tensor's {ndim} dims")
        return [_names(b) for b in self.spec] + [()] * (ndim - len(self.spec))

    def pieces_per_dim(self, ndim: int) -> list[int]:
        shape = self.mesh.shape
        return [math.prod(shape[n] for n in names)
                for names in self._dims(ndim)]

    def _piece_index(self, names: tuple[str, ...], pos: tuple[int, ...]
                     ) -> int:
        """The piece of a dim split over ``names`` held at ``pos``."""
        k = 0
        for n in names:
            a = self.mesh.axis_names.index(n)
            k = k * self.mesh.devices.shape[a] + pos[a]
        return k

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one piece; every split dim must divide evenly."""
        out = []
        for n, k in zip(shape, self.pieces_per_dim(len(shape))):
            if n % k:
                raise ValueError(f"{self.spec} splits a dim of {n} into {k} "
                                 f"uneven pieces (shape {tuple(shape)})")
            out.append(n // k)
        return tuple(out)

    def slices(self, shape: Sequence[int], pos: tuple[int, ...]
               ) -> tuple[slice, ...]:
        """The global index range of the piece at mesh position ``pos``."""
        piece = self.shard_shape(shape)
        return tuple(slice(self._piece_index(names, pos) * m,
                           (self._piece_index(names, pos) + 1) * m)
                     for names, m in zip(self._dims(len(shape)), piece))

    def is_leader(self, pos: tuple[int, ...]) -> bool:
        """Whether ``pos`` is index 0 on every mesh axis the spec does not
        use: the one position of each distinct piece."""
        used = {n for b in self.spec for n in _names(b)}
        return all(p == 0 for n, p in zip(self.mesh.axis_names, pos)
                   if n not in used)

    def shard(self, x: torch.Tensor) -> "ShardedTensor":
        """``x`` as one contiguous copy a mesh position, each on its
        position's device (never a view of ``x``)."""
        x = x.detach()
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        for pos in self.mesh.positions():
            piece = x[self.slices(x.shape, pos)]
            shards[pos] = piece.to(self.mesh.devices[pos], copy=True,
                                   memory_format=torch.contiguous_format)
        return ShardedTensor(self, tuple(x.shape), x.dtype, shards)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


class ShardedTensor:
    """A tensor held as its pieces, one a mesh position
    (:meth:`NamedSharding.shard`).  ``shape`` and ``dtype`` are the
    whole tensor's; ``shards[pos]`` is the piece at mesh position
    ``pos``.  Positions that hold the same piece (the axes the spec does
    not use) hold copies of it, which the sharded steps keep equal."""

    def __init__(self, sharding: NamedSharding, shape: tuple[int, ...],
                 dtype: torch.dtype, shards: np.ndarray):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def pieces(self) -> list[torch.Tensor]:
        """Every position's piece, row-major."""
        return [self.shards[pos] for pos in self.mesh.positions()]

    def leader_pieces(self) -> list[torch.Tensor]:
        """Each distinct piece once (:meth:`NamedSharding.is_leader`)."""
        return [self.shards[pos] for pos in self.mesh.positions()
                if self.sharding.is_leader(pos)]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedTensor":
        """``fn`` on every piece, the same sharding (``fn`` keeps each
        piece's shape and device)."""
        shards = np.empty(self.shards.shape, dtype=object)
        for pos in self.mesh.positions():
            shards[pos] = fn(self.shards[pos])
        dtype = shards[next(self.mesh.positions())].dtype
        return ShardedTensor(self.sharding, tuple(self.shape), dtype, shards)

    def _first(self) -> tuple[int, ...]:
        return next(self.mesh.positions())

    def gather_bytes(self, at: tuple[int, ...]) -> int:
        """The bytes a gather onto mesh position ``at`` moves: every piece
        but the one ``at`` holds."""
        whole = math.prod(self.shape) * torch.empty(
            (), dtype=self.dtype).element_size()
        return whole - self.nbytes_at(at)

    def gather(self, device: Any = None,
               at: tuple[int, ...] | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's):
        each distinct piece copied to its place.  ``at``, the mesh
        position gathering (default the first), is what
        :mod:`~repro_torch.parallel.traffic` counts it from."""
        dev = (self.shards[self._first()].device
               if device is None else torch.device(device))
        if traffic.active():
            traffic.report("all-gather", self.gather_bytes(
                self._first() if at is None else at))
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for pos in self.mesh.positions():
            if self.sharding.is_leader(pos):
                out[self.sharding.slices(self.shape, pos)].copy_(
                    self.shards[pos])
        return out

    def _overlaps(self, dim: int, start: int, stop: int):
        """(pos, piece slice, range in [start, stop)) of every position
        whose piece meets rows [start, stop) of ``dim``."""
        for pos in self.mesh.positions():
            sl = self.sharding.slices(self.shape, pos)
            lo, hi = max(sl[dim].start, start), min(sl[dim].stop, stop)
            if lo < hi:
                yield pos, sl, lo, hi

    def gather_rows(self, dim: int, start: int, stop: int,
                    out: torch.Tensor, at: tuple[int, ...] | None = None
                    ) -> torch.Tensor:
        """Rows [start, stop) of ``dim`` of the whole tensor, written into
        ``out`` (whose ``dim`` has stop - start rows).  ``at``: the mesh
        position gathering (default the first); the blocks of pieces it
        does not hold count as ``all-gather`` traffic."""
        count = traffic.active()
        mine = (self.sharding.slices(self.shape, at or self._first())
                if count else None)
        for pos, sl, lo, hi in self._overlaps(dim, start, stop):
            if not self.sharding.is_leader(pos):
                continue
            dst = list(sl)
            dst[dim] = slice(lo - start, hi - start)
            src = [slice(None)] * self.ndim
            src[dim] = slice(lo - sl[dim].start, hi - sl[dim].start)
            block = self.shards[pos][tuple(src)]
            out[tuple(dst)].copy_(block)
            if count and sl != mine:
                traffic.report("all-gather",
                               block.numel() * block.element_size())
        return out

    def scatter_rows(self, dim: int, start: int, src: torch.Tensor,
                     at: tuple[int, ...] | None = None) -> None:
        """Writes ``src`` as rows [start, start + len) of ``dim`` into
        every position's piece that holds them, in place.  ``at``: the
        mesh position writing (default the first); the blocks written to
        other positions count as ``collective-permute`` traffic."""
        count = traffic.active()
        at = at or self._first()
        stop = start + src.shape[dim]
        for pos, sl, lo, hi in self._overlaps(dim, start, stop):
            take = list(sl)
            take[dim] = slice(lo - start, hi - start)
            put = [slice(None)] * self.ndim
            put[dim] = slice(lo - sl[dim].start, hi - sl[dim].start)
            block = src[tuple(take)]
            self.shards[pos][tuple(put)].copy_(block)
            if count and pos != at:
                traffic.report("collective-permute",
                               block.numel() * block.element_size())

    def nbytes_at(self, pos: tuple[int, ...]) -> int:
        t = self.shards[pos]
        return t.numel() * t.element_size()

    def __int__(self) -> int:
        return int(self.gather("cpu"))

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", {self.sharding!r})")


# ----------------------------------------------------------------------
# trees of shardings
# ----------------------------------------------------------------------
def shard_tree(tree: Any, shardings: Any) -> Any:
    """Every tensor of a dict tree split by its sharding (a tree of
    :class:`NamedSharding` of the same structure, or one for all)."""
    if isinstance(shardings, NamedSharding):
        return tree_map(shardings.shard, tree)
    return tree_map(lambda x, s: s.shard(x), tree, shardings)


def gather_tree(tree: Any, device: Any = None) -> Any:
    """Every :class:`ShardedTensor` of a dict tree put back together on
    ``device``; plain tensors are moved there."""
    def one(x):
        if isinstance(x, ShardedTensor):
            return x.gather(device)
        return x if device is None else x.to(device)
    return tree_map(one, tree)


def resident_bytes(shardings: Any, like: Any) -> np.ndarray:
    """Bytes each mesh position holds of a tree whose leaves ``like``
    (anything with ``shape`` and ``dtype``, ``meta`` tensors too) are
    split by ``shardings`` (a tree of :class:`NamedSharding`): an array
    of the mesh's shape."""
    out: np.ndarray | None = None

    def add(s: NamedSharding, x):
        nonlocal out
        if out is None:
            out = np.zeros(s.mesh.devices.shape, dtype=np.int64)
        size = math.prod(s.shard_shape(tuple(x.shape)))
        out += size * torch.empty((), dtype=x.dtype).element_size()

    tree_map(add, shardings, like)
    return out


# ----------------------------------------------------------------------
# logical-axis rules
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    rules: tuple[tuple[str, AxisBinding], ...]
    #: logical axes allowed to shard unevenly (as activations only);
    #: attention heads are worth sharding even at 40/16.
    uneven_ok: frozenset[str] = frozenset()

    def binding(self, logical: str | None) -> AxisBinding:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def replace(self, **kw: AxisBinding) -> "ShardingRules":
        rules = tuple((k, kw.pop(k)) if k in kw else (k, v)
                      for k, v in self.rules)
        rules += tuple(kw.items())
        return dataclasses.replace(self, rules=rules)


#: training: DP over (pod, data); FSDP (weight sharding) over data;
#: TP over model; experts over model when divisible.
TRAIN_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("seq", None),
    ("embed", "data"),           # FSDP: weights' d_model dim over data
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("experts", "model"),
    ("expert_ff", None),         # used when experts don't divide
    ("ssm_inner", "model"),
    ("layers", None),
), uneven_ok=frozenset({"heads", "kv_heads"}))

#: serving: no FSDP (weights resident), TP over model, batch over data.
SERVE_RULES = TRAIN_RULES.replace(embed=None)


def mesh_axis_size(mesh: Any, binding: AxisBinding) -> int:
    """The number of pieces ``binding`` splits into on ``mesh`` (anything
    with a ``shape`` dict); axes the mesh lacks count 1."""
    if binding is None:
        return 1
    if isinstance(binding, str):
        return mesh.shape[binding] if binding in mesh.shape else 1
    return int(np.prod([mesh.shape.get(a, 1) for a in binding]))


def spec_for_axes(mesh: Any, rules: ShardingRules,
                  axes: tuple[str | None, ...],
                  shape: tuple[int, ...] | None = None,
                  notes: list[str] | None = None,
                  allow_uneven: bool = False) -> PartitionSpec:
    """PartitionSpec for one array given its logical axes (and shape, for
    divisibility checks), the reference's decisions exactly: each mesh
    axis used once, a dim left unsplit (and noted) where it does not
    divide, unless ``allow_uneven`` (activations only) and the logical
    axis is ``uneven_ok`` and at least the split's size.  Reads only
    ``mesh.shape``."""
    used: set[str] = set()
    dims: list[AxisBinding] = []
    for i, lg in enumerate(axes):
        b = rules.binding(lg)
        if b is None:
            dims.append(None)
            continue
        names = (b,) if isinstance(b, str) else tuple(b)
        names = tuple(n for n in names if n in mesh.shape and n not in used)
        if not names:
            dims.append(None)
            continue
        size = int(np.prod([mesh.shape[n] for n in names]))
        if shape is not None and shape[i] % size != 0:
            if allow_uneven and lg in rules.uneven_ok and shape[i] >= size:
                pass                       # an activation: accepted
            else:
                if notes is not None:
                    notes.append(
                        f"axis {lg!r} dim {shape[i]} !% {size} -> unsharded")
                dims.append(None)
                continue
        used.update(names)
        dims.append(names[0] if len(names) == 1 else names)
    return P(*dims)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def make_param_shardings(mesh: Mesh, axes: Any, rules: ShardingRules,
                         shapes: Any = None, notes: list[str] | None = None
                         ) -> Any:
    """Tree of :class:`NamedSharding` matching an axes tree (the port's
    ``param_axes``), with an optional tree of shapes (anything with a
    ``shape``: tensors, ``meta`` tensors, ``ParamDef``s) for the
    divisibility checks."""
    def walk(ax, sh):
        if _is_axes(ax):
            shape = None if sh is None else tuple(sh.shape)
            return NamedSharding(mesh, spec_for_axes(mesh, rules, ax, shape,
                                                     notes))
        return {k: walk(ax[k], None if sh is None else sh[k])
                for k in sorted(ax)}
    return walk(axes, shapes)
