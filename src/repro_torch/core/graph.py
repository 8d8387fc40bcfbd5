"""Dataflow graph extraction and validation (FLOWER contribution C1).

The paper extracts a dataflow graph from a single-source program: every
DSL call creates a *task* (here: :class:`Stage`), every virtual image /
``channel`` becomes an edge (:class:`Channel`).  The compiler validates
that the graph is acyclic and that every channel is written exactly once
and read exactly once (fan-out must be explicit via a ``split`` stage),
mirroring Section IV-A of the paper.

Stages are *untimed* descriptions of computation on whole logical
arrays; the scheduler (:mod:`repro_torch.core.schedule`) decides tiling
and the lowering (:mod:`repro_torch.core.fusion`) turns fusion groups
into either one generated CUDA kernel or a chain of torch ops.

Port of :mod:`repro.core.graph`: channel dtypes are torch dtypes and the
reference semantics run on torch tensors (same zero padding).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "Channel",
    "Stage",
    "DataflowGraph",
    "GraphError",
    "CycleError",
    "ChannelContractError",
    "as_dtype",
    "dtype_name",
    "extract_patches",
    "window_rows",
    "as_inputs",
]


def as_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype for ``dtype`` (a torch dtype, numpy dtype or type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def dtype_name(dtype: Any) -> str:
    """``float32``-style name of a torch (or numpy) dtype."""
    return str(as_dtype(dtype)).removeprefix("torch.")


class GraphError(ValueError):
    """Base class for dataflow-graph validation errors."""


class CycleError(GraphError):
    """The dataflow graph contains a cycle."""


class ChannelContractError(GraphError):
    """A channel violates the single-writer / single-reader contract."""


@dataclasses.dataclass(eq=False)
class Channel:
    """An edge of the dataflow graph (the paper's ``channel``).

    A channel that has no producer is a *graph input* (it will be fed
    from HBM by a generated read task); a channel marked as output is a
    *graph output* (drained to HBM by a generated write task).
    """

    name: str
    shape: tuple[int, ...]
    dtype: Any
    producer: "Stage | None" = None
    consumers: list["Stage"] = dataclasses.field(default_factory=list)
    is_graph_input: bool = False
    is_graph_output: bool = False
    #: memory-bundle id (paper: AXI bundle ``mem1..4``); assigned by the
    #: scheduler for graph I/O channels only.
    bundle: int | None = None
    #: FIFO depth (double buffering by default, like ``depth = 2``).
    depth: int = 2

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Channel({self.name}, {self.shape}, {dtype_name(self.dtype)},"
                f" in={self.is_graph_input}, out={self.is_graph_output})")

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * as_dtype(self.dtype).itemsize


@dataclasses.dataclass(eq=False)
class Stage:
    """A node of the dataflow graph (the paper's *task*).

    ``kind`` determines how the stage is scheduled and lowered:

    - ``point``:    elementwise, ``fn(x) -> y`` (shape preserving)
    - ``pointN``:   elementwise over N inputs, ``fn(x1..xN) -> y``
    - ``stencil``:  local operator with window ``(kh, kw)``;
                    ``fn(patches)`` where ``patches`` has shape
                    ``(kh*kw, *tile)`` holding the shifted views
                    (line-buffer analogue)
    - ``split``:    1 input -> k identical outputs (explicit fan-out)
    - ``reduce``:   global reduction ``fn(x) -> scalar/vector``
    - ``custom``:   opaque whole-array function (breaks fusion groups;
                    used to embed hand-written kernels)
    """

    name: str
    kind: str
    fn: Callable[..., Any] | None
    inputs: list[Channel]
    outputs: list[Channel]
    #: stencil window (kh, kw); (1, 1) for non-stencil stages.
    window: tuple[int, int] = (1, 1)
    #: per-item issue interval in cycles for the latency simulator.
    ii: float = 1.0
    #: pipeline fill latency in cycles for the latency simulator.
    fill: float = 8.0
    #: extra metadata (e.g. custom lowering hooks).
    meta: dict = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Stage({self.name}:{self.kind})"

    @property
    def halo(self) -> tuple[int, int]:
        return ((self.window[0] - 1) // 2, (self.window[1] - 1) // 2)


class DataflowGraph:
    """A FLOWER dataflow graph under construction.

    The builder methods mirror the AnyHLS image-processing DSL
    (``iteration_point``, ``split_image``, ...) from the paper's running
    example.  Calling them *is* the graph extraction: the user writes a
    single-source program, and the graph falls out of the calls.

    Explicit channels (``graph.channel(...)`` + ``graph.task(...)``)
    are supported too, matching the paper's ``static mut chan`` style;
    with them the user can construct invalid graphs, which
    :meth:`validate` rejects with precise errors.
    """

    def __init__(self, name: str = "app") -> None:
        self.name = name
        self.stages: list[Stage] = []
        self.channels: list[Channel] = []
        self._counter = 0

    # ------------------------------------------------------------------
    # channel / task primitives (explicit wiring, paper-style)
    # ------------------------------------------------------------------
    def _fresh(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}{self._counter}"

    def channel(self, shape: Sequence[int], dtype: Any = torch.float32,
                name: str | None = None) -> Channel:
        ch = Channel(name or self._fresh("chan"), tuple(shape), dtype)
        self.channels.append(ch)
        return ch

    def input(self, name: str, shape: Sequence[int],
              dtype: Any = torch.float32) -> Channel:
        """Declare a graph input (an HBM-resident image/tensor)."""
        ch = self.channel(shape, dtype, name=name)
        ch.is_graph_input = True
        return ch

    def output(self, ch: Channel, name: str | None = None) -> Channel:
        """Mark a channel as a graph output (drained to HBM)."""
        if name is not None:
            ch.name = name
        ch.is_graph_output = True
        return ch

    def task(self, name: str, kind: str, fn: Callable | None,
             inputs: Sequence[Channel], outputs: Sequence[Channel],
             window: tuple[int, int] = (1, 1), *, ii: float = 1.0,
             fill: float = 8.0, meta: dict | None = None) -> Stage:
        st = Stage(name, kind, fn, list(inputs), list(outputs),
                   window=window, ii=ii, fill=fill, meta=meta or {})
        for ch in inputs:
            ch.consumers.append(st)
        for ch in outputs:
            if ch.producer is not None:
                raise ChannelContractError(
                    f"channel {ch.name!r} written by both "
                    f"{ch.producer.name!r} and {st.name!r}")
            ch.producer = st
        self.stages.append(st)
        return st

    # ------------------------------------------------------------------
    # DSL builders (implicit wiring; these mirror the AnyHLS library)
    # ------------------------------------------------------------------
    def point(self, x: Channel, fn: Callable, name: str | None = None,
              dtype: Any = None, **kw) -> Channel:
        """``iteration_point``: out[x, y] = fn(in[x, y])."""
        out = self.channel(x.shape, dtype or x.dtype)
        self.task(name or self._fresh("point"), "point", fn, [x], [out], **kw)
        return out

    def point2(self, a: Channel, b: Channel, fn: Callable,
               name: str | None = None, dtype: Any = None, **kw) -> Channel:
        """``iteration_point2``: out = fn(a, b) elementwise."""
        if a.shape != b.shape:
            raise GraphError(
                f"point2 stage {_stage_label(name)}: elementwise inputs "
                f"must agree on shape — expected both {a.shape} "
                f"({a.name!r}), got {b.shape} ({b.name!r})"
                f"{_src_note(kw.get('meta'))}")
        out = self.channel(a.shape, dtype or a.dtype)
        self.task(name or self._fresh("point2"), "pointN", fn, [a, b], [out], **kw)
        return out

    def pointn(self, chans: Sequence[Channel], fn: Callable,
               name: str | None = None, dtype: Any = None, **kw) -> Channel:
        shapes = {c.shape for c in chans}
        if len(shapes) != 1:
            got = ", ".join(f"{c.name!r}={c.shape}" for c in chans)
            raise GraphError(
                f"pointn stage {_stage_label(name)}: elementwise inputs "
                f"must agree on one shape, got {got}"
                f"{_src_note(kw.get('meta'))}")
        out = self.channel(chans[0].shape, dtype or chans[0].dtype)
        self.task(name or self._fresh("pointn"), "pointN", fn, list(chans),
                  [out], **kw)
        return out

    def stencil(self, x: Channel, window: tuple[int, int], fn: Callable,
                name: str | None = None, dtype: Any = None, **kw) -> Channel:
        """Local operator: ``fn(patches)`` with patches ``(kh*kw, *tile)``.

        Edge handling is zero-padding (the scheduler materializes the
        halo; see :mod:`repro.core.fusion`).
        """
        if window[0] % 2 != 1 or window[1] % 2 != 1:
            raise GraphError(
                f"stencil stage {_stage_label(name)}: window must be odd "
                f"so the halo is symmetric — expected odd (kh, kw), got "
                f"{window}{_src_note(kw.get('meta'))}")
        if len(x.shape) != 2:
            raise GraphError(
                f"stencil stage {_stage_label(name)}: expects a 2-D "
                f"plane, got input {x.name!r} of shape {x.shape}"
                f"{_src_note(kw.get('meta'))}")
        out = self.channel(x.shape, dtype or x.dtype)
        self.task(name or self._fresh("stencil"), "stencil", fn, [x], [out],
                  window=window, **kw)
        return out

    def split(self, x: Channel, k: int = 2, name: str | None = None,
              **kw) -> tuple[Channel, ...]:
        """``split_image``: explicit fan-out of a channel to k copies."""
        outs = tuple(self.channel(x.shape, x.dtype) for _ in range(k))
        self.task(name or self._fresh("split"), "split", None, [x],
                  list(outs), **kw)
        return outs

    def reduce(self, x: Channel, fn: Callable, out_shape: Sequence[int] = (),
               name: str | None = None, dtype: Any = None, **kw) -> Channel:
        out = self.channel(tuple(out_shape), dtype or x.dtype)
        self.task(name or self._fresh("reduce"), "reduce", fn, [x], [out], **kw)
        return out

    def custom(self, chans: Sequence[Channel], fn: Callable,
               out_shapes: Sequence[tuple[int, ...]],
               out_dtypes: Sequence[Any] | None = None,
               name: str | None = None, meta: dict | None = None,
               **kw) -> tuple[Channel, ...]:
        """Opaque whole-array stage (embeds hand-written kernels)."""
        out_dtypes = out_dtypes or [chans[0].dtype] * len(out_shapes)
        outs = tuple(self.channel(s, d) for s, d in zip(out_shapes, out_dtypes))
        self.task(name or self._fresh("custom"), "custom", fn, list(chans),
                  list(outs), meta=meta, **kw)
        return outs

    # ------------------------------------------------------------------
    # validation (paper Section IV-A) and topological sort
    # ------------------------------------------------------------------
    @property
    def graph_inputs(self) -> list[Channel]:
        return [c for c in self.channels if c.is_graph_input]

    @property
    def graph_outputs(self) -> list[Channel]:
        return [c for c in self.channels if c.is_graph_output]

    def validate(self) -> None:
        """Check the canonical-form contract; raise GraphError if violated."""
        for ch in self.channels:
            n_writers = 0 if ch.producer is None else 1
            if ch.is_graph_input and n_writers:
                raise ChannelContractError(
                    f"graph input {ch.name!r} must not have a producer "
                    f"(written by {ch.producer.name!r})")
            if not ch.is_graph_input and ch.producer is None:
                raise ChannelContractError(
                    f"channel {ch.name!r} is never written and is not a "
                    f"graph input")
            n_readers = len(ch.consumers)
            if n_readers > 1:
                names = [s.name for s in ch.consumers]
                raise ChannelContractError(
                    f"channel {ch.name!r} is read {n_readers} times by "
                    f"{names}; insert an explicit split stage")
            if n_readers == 0 and not ch.is_graph_output:
                raise ChannelContractError(
                    f"channel {ch.name!r} is never read and is not a graph "
                    f"output")
            if ch.is_graph_output and ch.is_graph_input:
                raise ChannelContractError(
                    f"channel {ch.name!r} cannot be both graph input and "
                    f"output")
        self.toposort()  # raises CycleError on cycles

    def toposort(self) -> list[Stage]:
        """Kahn's algorithm; deterministic (insertion order tie-break).

        This is the paper's scheduling step: the generated top-level
        kernel calls tasks in this order so every channel is written
        before it is read.  Stages disconnected from the rest still get
        scheduled (the paper: "tasks that are isolated from the rest of
        the graph ... execute in parallel with the rest").
        """
        indeg: dict[Stage, int] = {}
        for st in self.stages:
            indeg[st] = sum(1 for ch in st.inputs if ch.producer is not None)
        ready = collections.deque(st for st in self.stages if indeg[st] == 0)
        order: list[Stage] = []
        while ready:
            st = ready.popleft()
            order.append(st)
            for ch in st.outputs:
                for consumer in ch.consumers:
                    indeg[consumer] -= 1
                    if indeg[consumer] == 0:
                        ready.append(consumer)
        if len(order) != len(self.stages):
            placed = set(order)
            stuck = [s for s in self.stages if s not in placed]
            chans = sorted({ch.name for s in stuck for ch in s.inputs
                            if ch.producer is not None
                            and ch.producer not in placed})
            raise CycleError(
                f"dataflow graph has a cycle through stages "
                f"{[s.name for s in stuck]} (channels {chans})")
        return order

    # ------------------------------------------------------------------
    # canonical signature (the compile-cache key)
    # ------------------------------------------------------------------
    def signature(self) -> str:
        """Canonical structural digest of the graph.

        Two graphs get the same signature iff they have the same
        topology, shapes, dtypes, stencil windows, FIFO depths, graph
        I/O channel names (the compiled app's calling convention) and
        stage bodies (a best-effort bytecode+closure fingerprint; see
        :func:`_fn_fingerprint`).  *Internal* channel and stage names
        do not matter, so a relabeled copy of a graph hits the compile
        cache (:class:`repro.runtime.cache.CompileCache`).  Signatures
        are computed in topological order, so they are stable across
        construction orderings of the same DAG.
        """
        ids: dict[Channel, int] = {}

        def cid(ch: Channel) -> str:
            if ch not in ids:
                ids[ch] = len(ids)
            return f"c{ids[ch]}"

        # graph I/O channel NAMES are part of the signature: they are
        # the compiled app's calling convention (input/output keywords),
        # so two graphs differing only in I/O names must not share an
        # app.  Internal channel names stay excluded.
        lines = [f"in {cid(ch)} name={ch.name} {ch.shape} "
                 f"{dtype_name(ch.dtype)} depth={ch.depth}"
                 for ch in self.graph_inputs]
        for st in self.toposort():
            ins = ",".join(cid(c) for c in st.inputs)
            outs = ",".join(
                f"{cid(c)}:{c.shape}:{dtype_name(c.dtype)}:d{c.depth}"
                for c in st.outputs)
            lines.append(f"stage {st.kind} w={st.window} "
                         f"fn={_fn_fingerprint(st.fn)} [{ins}]->[{outs}]")
        lines.extend(f"out {cid(ch)} name={ch.name}"
                     for ch in self.graph_outputs)
        return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]

    # ------------------------------------------------------------------
    # reference semantics: execute the graph stage-by-stage with torch
    # ops on whole tensors.  This is the oracle every backend is
    # checked against.
    # ------------------------------------------------------------------
    def reference_eval(self, inputs: dict[str, Any]) -> dict[str, Any]:
        self.validate()
        env: dict[Channel, Any] = {}
        for ch in self.graph_inputs:
            if ch.name not in inputs:
                raise GraphError(f"missing graph input {ch.name!r}")
            val = torch.as_tensor(inputs[ch.name], dtype=as_dtype(ch.dtype))
            if tuple(val.shape) != ch.shape:
                raise GraphError(
                    f"input {ch.name!r}: expected shape {ch.shape}, got "
                    f"{tuple(val.shape)}")
            env[ch] = val
        for st in self.toposort():
            vals = [env[c] for c in st.inputs]
            outs = _apply_stage_reference(st, vals)
            for ch, v in zip(st.outputs, outs):
                env[ch] = v.to(as_dtype(ch.dtype))
        return {ch.name: env[ch] for ch in self.graph_outputs}


def _stage_label(name: str | None) -> str:
    return repr(name) if name else "<unnamed>"


def _src_note(meta: dict | None) -> str:
    """Render the user source location a traced stage carries.

    The tracing frontend (:mod:`repro_torch.frontend`) records the user's
    ``file.py:line`` in ``Stage.meta["src"]`` at record time; stage
    validation errors append it so a bad traced program points at the
    line the user wrote, not at tracer internals.
    """
    src = (meta or {}).get("src")
    return f" (traced at {src})" if src else ""


def _fn_fingerprint(fn: Any, _depth: int = 0) -> str:
    """Best-effort structural fingerprint of a stage function.

    Hashes the bytecode, code constants, referenced global/attribute
    names (with the globals resolved to their current values, so
    ``lambda x: torch.abs(x)`` and ``lambda x: torch.exp(x)`` differ),
    argument defaults, and (recursively) the closure cells.  Values
    without a stable value-based repr fall back to ``id()`` —
    conservative: the signature then only matches the exact same
    function object, which can cost cache hits but never returns a
    wrong kernel.

    Stability matters *across processes*: persistent caches key on
    this digest, so the fingerprint must not depend on memory
    addresses.  Nested code
    objects (genexprs, inner lambdas) therefore hash structurally via
    :func:`_code_fingerprint` — their default ``repr`` embeds an
    ``at 0x…`` address that would silently break every cross-process
    cache hit for stages like ``lambda p: sum(p[i] for i in range(9))``.
    """
    if fn is None:
        return "none"
    code = getattr(fn, "__code__", None)
    if code is None or _depth > 4:
        name = (getattr(fn, "__qualname__", None)
                or getattr(fn, "__name__", None))
        if name:
            return f"{getattr(fn, '__module__', '')}.{name}"
        return f"id{id(fn)}"
    parts = [_code_fingerprint(code), repr(code.co_names)]
    fglobals = getattr(fn, "__globals__", {})
    for name in code.co_names:
        if name in fglobals:
            parts.append(_const_fingerprint(fglobals[name], _depth + 1))
    for dflt in (fn.__defaults__ or ()):
        parts.append(_const_fingerprint(dflt, _depth + 1))
    for dflt in (fn.__kwdefaults__ or {}).values():
        parts.append(_const_fingerprint(dflt, _depth + 1))
    for cell in (fn.__closure__ or ()):
        parts.append(_const_fingerprint(cell.cell_contents, _depth + 1))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def _code_fingerprint(code: Any) -> str:
    """Address-free digest of a code object, nested code included."""
    parts = [code.co_code.hex(), repr(code.co_names),
             repr(code.co_varnames)]
    for c in code.co_consts:
        if hasattr(c, "co_code"):           # nested genexpr/lambda/comp
            parts.append(_code_fingerprint(c))
        else:
            parts.append(repr(c))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def _const_fingerprint(v: Any, depth: int) -> str:
    if callable(v):
        return _fn_fingerprint(v, depth)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_const_fingerprint(x, depth) for x in v) + "]"
    if isinstance(v, np.ndarray):
        return hashlib.sha256(v.tobytes()).hexdigest()[:12] + str(v.shape)
    if isinstance(v, torch.Tensor):
        a = v.detach().cpu().numpy()
        return hashlib.sha256(a.tobytes()).hexdigest()[:12] + str(a.shape)
    r = repr(v)
    if " at 0x" in r:              # default object repr: identity only
        return f"id{id(v)}"
    return r


def extract_patches(x: torch.Tensor, window: tuple[int, int]
                    ) -> torch.Tensor:
    """Zero-padded shifted views, shape ``(kh*kw, *x.shape)``.

    This is the reference semantics of a stencil stage's input: the
    FPGA line buffer delivering the window, in tile form.
    """
    kh, kw = window
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    h, w = x.shape
    views = [xp[i:i + h, j:j + w] for i in range(kh) for j in range(kw)]
    return torch.stack(views, dim=0)


def as_inputs(graph: "DataflowGraph", arrays: dict[str, Any],
              device: Any = None) -> dict[str, torch.Tensor]:
    """The port's input tensors for the numpy planes the JAX package
    takes: one tensor per graph input, in the channel's dtype, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    out = {}
    for ch in graph.graph_inputs:
        if ch.name not in arrays:
            raise GraphError(f"missing graph input {ch.name!r}")
        out[ch.name] = torch.as_tensor(np.asarray(arrays[ch.name]),
                                       dtype=as_dtype(ch.dtype), device=dev)
    return out


def window_rows(x: torch.Tensor, valid_rows: tuple[int, int]) -> torch.Tensor:
    """Zero rows of a 2-D plane outside the ``[r0, r1)`` band.

    The semantics of a *window* of a larger plane: every stage output
    outside the band reads as zero, as if the plane ended there.
    """
    if x.ndim != 2:
        return x
    r0, r1 = valid_rows
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.where((rows >= r0) & (rows < r1), x, torch.zeros_like(x))


def _apply_stage_reference(st: Stage, vals: list[Any]) -> list[Any]:
    if st.kind == "point":
        return [st.fn(vals[0])]
    if st.kind == "pointN":
        return [st.fn(*vals)]
    if st.kind == "stencil":
        return [st.fn(extract_patches(vals[0], st.window))]
    if st.kind == "split":
        return [vals[0] for _ in st.outputs]
    if st.kind == "reduce":
        return [st.fn(vals[0])]
    if st.kind == "custom":
        out = st.fn(*vals)
        return list(out) if isinstance(out, (tuple, list)) else [out]
    raise GraphError(f"unknown stage kind {st.kind!r}")
