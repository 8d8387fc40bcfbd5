"""Canonicalization passes (FLOWER's *automatic transformations*).

The paper's headline claim is that the programmer writes the natural
single-source program and the compiler rewrites it into the canonical
dataflow form — nobody hand-inserts ``split`` stages or prunes dead
arms.  This module is that mid-end: a tiny pass manager in the style
of LLVM/MLIR (and of the transformation catalogue in "Transformations
of High-Level Synthesis Codes for High-Performance Computing").

Port of :mod:`repro.core.transform`: pure graph passes, unchanged in
logic; the fused point body casts with ``Tensor.to``.

Every pass takes a :class:`~repro_torch.core.graph.DataflowGraph`, rewrites
it **in place** (so Channel/Stage objects held by the caller stay
valid), and returns ``(graph, diagnostics)`` where ``diagnostics`` is
a human-readable list of what was changed.  :class:`PassPipeline`
chains passes and tags each diagnostic with the pass name; the
scheduler surfaces them through ``Schedule.describe()``.

Built-in passes:

- :class:`AutoSplitInsertion` — rewrite every multi-reader channel
  into an explicit ``split`` stage (the canonical-form transformation
  of paper Section IV-A; without it the validator rejects the graph).
- :class:`DeadChannelElimination` — drop channels that are never read
  (and the stages that only feed them), prune dead ``split`` arms, and
  collapse single-arm splits into a wire.
- :class:`PointFusion` — compose adjacent ``point``/``pointN`` stages
  into one stage so the scheduler sees fewer FIFO hops (the classical
  producer/consumer elementwise fusion; bit-exact because function
  composition preserves op order).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core.graph import Channel, DataflowGraph, Stage, as_dtype

__all__ = [
    "Pass",
    "PassPipeline",
    "AutoSplitInsertion",
    "DeadChannelElimination",
    "PointFusion",
    "default_pipeline",
]

#: stage kinds PointFusion may compose
_POINT_KINDS = frozenset({"point", "pointN"})


@runtime_checkable
class Pass(Protocol):
    """A graph-to-graph rewrite with human-readable diagnostics."""

    name: str

    def run(self, graph: DataflowGraph
            ) -> tuple[DataflowGraph, list[str]]: ...


@dataclasses.dataclass
class PassPipeline:
    """Run a sequence of passes, collecting tagged diagnostics.

    With a :class:`~repro_torch.obs.tracer.Tracer` passed as ``tracer``,
    every pass runs inside a ``compile.pass.<name>`` span carrying its
    rewrite count — per-pass timing and diagnostics in the flight
    recorder, the compile-side analogue of the engine's phase spans.
    """

    passes: tuple[Pass, ...]

    def run(self, graph: DataflowGraph, tracer=None
            ) -> tuple[DataflowGraph, list[str]]:
        diags: list[str] = []
        for p in self.passes:
            if tracer is None:
                graph, d = p.run(graph)
            else:
                with tracer.span(f"compile.pass.{p.name}", cat="compile",
                                 graph=graph.name) as sp:
                    graph, d = p.run(graph)
                    sp.set(rewrites=len(d))
            diags.extend(f"[{p.name}] {line}" for line in d)
        return graph, diags


def default_pipeline(extra: Sequence[Pass] = ()) -> PassPipeline:
    """The canonicalization pipeline ``compile_graph`` runs by default."""
    return PassPipeline((AutoSplitInsertion(), DeadChannelElimination(),
                         PointFusion(), *extra))


# ----------------------------------------------------------------------
# AutoSplitInsertion
# ----------------------------------------------------------------------
class AutoSplitInsertion:
    """Make fan-out explicit: k readers of one channel -> one ``split``.

    For every channel read more than once, insert a ``split`` stage
    that copies the channel into one fresh channel per read site and
    rewire each reader onto its private copy.  A reader consuming the
    same channel at several input positions gets one copy per
    position.  After this pass the single-writer/single-reader channel
    contract holds and ``validate()`` accepts the graph.
    """

    name = "auto-split"

    def run(self, graph: DataflowGraph) -> tuple[DataflowGraph, list[str]]:
        diags: list[str] = []
        for ch in list(graph.channels):
            if len(ch.consumers) <= 1:
                continue
            sites = [(st, i) for st in dict.fromkeys(ch.consumers)
                     for i, ic in enumerate(st.inputs) if ic is ch]
            copies: list[Channel] = []
            for st, i in sites:
                cp = Channel(f"{ch.name}.{len(copies)}", ch.shape, ch.dtype)
                cp.consumers = [st]
                st.inputs[i] = cp
                graph.channels.append(cp)
                copies.append(cp)
            split = Stage(f"autosplit_{ch.name}", "split", None,
                          [ch], copies)
            for cp in copies:
                cp.producer = split
            ch.consumers = [split]
            graph.stages.append(split)
            diags.append(
                f"channel {ch.name!r} read {len(sites)}x by "
                f"{sorted({st.name for st, _ in sites})}; inserted "
                f"{split.name!r} with {len(copies)} arms")
        return graph, diags


# ----------------------------------------------------------------------
# DeadChannelElimination
# ----------------------------------------------------------------------
class DeadChannelElimination:
    """Remove channels nobody reads and the stages that only feed them.

    Iterates to a fixpoint: pruning a stage can orphan its input
    channels, which may in turn kill their producers.  ``split`` arms
    are pruned individually, and a split left with a single live arm
    is collapsed into a plain wire (reader moved onto the split's
    input) unless the arm is a graph output.  Unread graph inputs are
    dropped from the graph (they become unused launcher buffers).
    """

    name = "dead-channel"

    def run(self, graph: DataflowGraph) -> tuple[DataflowGraph, list[str]]:
        diags: list[str] = []
        changed = True
        while changed:
            changed = False
            for ch in list(graph.channels):
                if ch not in graph.channels:   # sibling removed this sweep
                    continue
                if ch.consumers or ch.is_graph_output:
                    continue
                st = ch.producer
                if st is None:
                    graph.channels.remove(ch)
                    diags.append(
                        f"removed unread {'input ' if ch.is_graph_input else ''}"
                        f"channel {ch.name!r}")
                    changed = True
                elif st.kind == "split" and len(st.outputs) > 1:
                    st.outputs.remove(ch)
                    graph.channels.remove(ch)
                    diags.append(f"pruned dead arm {ch.name!r} of split "
                                 f"{st.name!r}")
                    changed = True
                elif all(not o.consumers and not o.is_graph_output
                         for o in st.outputs):
                    for o in st.outputs:
                        graph.channels.remove(o)
                    for ic in st.inputs:
                        ic.consumers.remove(st)
                    graph.stages.remove(st)
                    diags.append(f"removed dead stage {st.name!r} "
                                 f"(outputs {[o.name for o in st.outputs]} "
                                 f"never read)")
                    changed = True
            for st in list(graph.stages):
                if (st.kind == "split" and len(st.outputs) == 1
                        and not st.outputs[0].is_graph_output):
                    out, src = st.outputs[0], st.inputs[0]
                    for reader in list(out.consumers):
                        for i, ic in enumerate(reader.inputs):
                            if ic is out:
                                reader.inputs[i] = src
                    src.consumers = [c for c in src.consumers if c is not st]
                    src.consumers.extend(out.consumers)
                    graph.channels.remove(out)
                    graph.stages.remove(st)
                    diags.append(f"collapsed single-arm split {st.name!r} "
                                 f"into a wire")
                    changed = True
        return graph, diags


# ----------------------------------------------------------------------
# PointFusion
# ----------------------------------------------------------------------
class PointFusion:
    """Compose producer/consumer elementwise stages into one stage.

    An edge ``p -> c`` is fused when both stages are ``point``/
    ``pointN``, the connecting channel has ``c`` as its only reader
    and is not a graph output.  The consumer absorbs the producer: its
    input list splices in the producer's inputs at the edge position
    and its ``fn`` becomes the composition (including the intermediate
    dtype cast, so reference semantics are preserved bit-exactly).
    """

    name = "point-fusion"

    def run(self, graph: DataflowGraph) -> tuple[DataflowGraph, list[str]]:
        diags: list[str] = []
        while True:
            edge = self._find_edge(graph)
            if edge is None:
                break
            prod, cons, ch = edge
            pos = next(i for i, ic in enumerate(cons.inputs) if ic is ch)
            cons.fn = _compose(prod.fn, len(prod.inputs), cons.fn, pos, ch)
            cons.inputs[pos:pos + 1] = prod.inputs
            for ic in prod.inputs:
                ic.consumers = [cons if c is prod else c
                                for c in ic.consumers]
            graph.stages.remove(prod)
            graph.channels.remove(ch)
            old = cons.name
            cons.name = f"{prod.name}+{cons.name}"
            cons.kind = "point" if len(cons.inputs) == 1 else "pointN"
            # a fully pipelined fused datapath issues at the slower of
            # the two rates and pays both fill latencies
            cons.ii = max(prod.ii, cons.ii)
            cons.fill = prod.fill + cons.fill
            diags.append(f"fused {prod.name!r} into {old!r} "
                         f"(channel {ch.name!r} eliminated)")
        return graph, diags

    @staticmethod
    def _find_edge(graph: DataflowGraph
                   ) -> tuple[Stage, Stage, Channel] | None:
        for st in graph.stages:
            if st.kind not in _POINT_KINDS:
                continue
            ch = st.outputs[0]
            if ch.is_graph_output or len(ch.consumers) != 1:
                continue
            cons = ch.consumers[0]
            # cons is st on a (invalid, pre-validate) self-loop: never
            # fuse it away — validate() must see the cycle and raise
            if cons.kind in _POINT_KINDS and cons is not st:
                return st, cons, ch
        return None


def _compose(p_fn: Callable, n_p: int, c_fn: Callable, pos: int,
             mid: Channel) -> Callable:
    dtype = as_dtype(mid.dtype)

    def fused(*args):
        inner = p_fn(*args[pos:pos + n_p]).to(dtype)
        return c_fn(*args[:pos], inner, *args[pos + n_p:])

    return fused
