"""Scheduling: convex DAG fusion, halo accumulation, bundles.

Port of :mod:`repro.core.schedule`, unchanged in logic.  Given a
:class:`DataflowGraph`, the scheduler

1. canonicalizes the graph through the pass pipeline
   (:mod:`repro_torch.core.transform`) unless ``strict=True``,
2. topologically sorts the stages (write-before-read order),
3. partitions them into *fusion groups* by **convex-subgraph DAG
   fusion**: every tile-streamable stage starts in its own group and
   groups are merged pairwise — best latency win first, as scored by
   :func:`repro_torch.core.simulate.analytic_latency` — as long as the
   union stays convex (no path leaves the group and re-enters) and the
   halo windows of its live channels still fit one thread block's
   shared memory (:func:`repro_torch.core.vectorize.choose_tile` is the
   budget oracle); ``custom`` and ``reduce`` stages stay group-breaking
   singletons,
4. computes the *cumulative halo* each channel must carry so that
   downstream stencils have their windows available inside the fused
   kernel (the line-buffer analysis),
5. assigns memory bundles to graph I/O channels (paper Fig. 4).

The one change from the reference is the budget: the TPU kernel
double-buffers every channel in VMEM, the CUDA kernel holds one
halo window per channel with a halo in shared memory and keeps
halo-free channels in registers (:meth:`FusionGroup.smem_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.graph import (Channel, DataflowGraph, GraphError,
                                    Stage, as_dtype)
from repro_torch.core.simulate import TaskTiming, analytic_latency
from repro_torch.core.transform import Pass, PassPipeline, default_pipeline
from repro_torch.obs.tracer import maybe_span

__all__ = ["FusionGroup", "Schedule", "build_schedule", "pad4"]

#: stage kinds that can be fused into one streaming kernel
FUSIBLE_KINDS = frozenset({"point", "pointN", "stencil", "split"})

#: items used by the merge cost model (plane size is tile-agnostic here)
_COST_ITEMS = 1 << 20


@dataclasses.dataclass
class FusionGroup:
    """A set of stages lowered to a single streaming kernel."""

    stages: list[Stage]
    #: channels entering the group (read from device memory by the kernel)
    inputs: list[Channel]
    #: channels leaving the group (written to device memory by the kernel)
    outputs: list[Channel]
    #: channels internal to the group (shared-memory only; the FIFOs)
    internal: list[Channel]
    #: per-channel cumulative halo (hy, hx) required inside the kernel
    halo: dict[Channel, tuple[int, int]]
    #: selected tile (th, tw); filled in by the vectorizer
    tile: tuple[int, int] | None = None
    #: vector factor behind the selected tile (tw == 32 * vector_factor,
    #: one warp-wide row segment per factor)
    vector_factor: int | None = None
    #: why this tile was chosen: "model" (analytic sweep), "forced"
    #: (explicit vector_factor=), or the autotuner's provenance
    #: ("measured", "cache", "config").  Rendered by
    #: :meth:`Schedule.describe`.
    tile_source: str = "model"

    @property
    def is_trivial(self) -> bool:
        """Groups of one non-fusible stage (custom / reduce)."""
        return len(self.stages) == 1 and self.stages[0].kind not in FUSIBLE_KINDS

    def is_direct(self, ch: Channel) -> bool:
        """A group output the kernel stores straight to device memory.

        A halo-free output written by a non-split stage needs no
        shared-memory window: its stage writes the tile's centre to the
        output plane directly.
        """
        return (ch in self.outputs and self.halo.get(ch, (0, 0)) == (0, 0)
                and ch.producer is not None and ch.producer.kind != "split")

    def buffered_channels(self) -> list[Channel]:
        """Channels that own a shared-memory halo window in the kernel.

        Group inputs and stage outputs with a halo, except split arms
        (which alias their source's window).  A halo-free channel is
        read only at offset (0, 0), by stages over the tile's centre, so
        the kernel keeps it in registers (a halo-free group input is
        read straight from device memory).
        """
        out = [ch for ch in self.inputs if self.halo.get(ch, (0, 0)) != (0, 0)]
        for st in self.stages:
            if st.kind == "split":
                continue
            out.extend(ch for ch in st.outputs
                       if self.halo.get(ch, (0, 0)) != (0, 0))
        return out

    def smem_bytes(self, tile: tuple[int, int] | None = None) -> int:
        """Shared memory one thread block holds for a candidate tile:
        a ``(th + 2hy, tw + 2 pad4(hx))`` window per buffered channel
        (columns padded to 16-byte rows, :func:`pad4`)."""
        tile = tile or self.tile
        if tile is None:
            raise GraphError("no tile selected for group")
        th, tw = tile
        total = 0
        for ch in self.buffered_channels():
            hy, hx = self.halo.get(ch, (0, 0))
            total += (th + 2 * hy) * (tw + 2 * pad4(hx)) * _itemsize(ch)
        return total


def pad4(hx: int) -> int:
    """A window's column margin in the group kernel: the halo rounded up
    to 4 floats, so every window row starts 16-byte aligned in device
    and shared memory (``sg::pad4`` in ``csrc/stream_group.cuh``)."""
    return (hx + 3) & ~3


def _itemsize(ch: Channel) -> int:
    return as_dtype(ch.dtype).itemsize


@dataclasses.dataclass
class Schedule:
    """The partitioned program: what the lowering turns into kernels.

    Produced by :func:`build_schedule`; carried by every
    :class:`~repro_torch.core.host.CompiledApp` as ``app.schedule``.  Holds
    the (post-canonicalization) graph, the stage execution order, the
    fusion groups with their selected tiles, the memory-bundle map,
    and the human-readable diagnostics trail of every decision the
    compiler made on the way here.
    """

    graph: DataflowGraph
    order: list[Stage]
    groups: list[FusionGroup]
    #: bundle id per graph-I/O channel (paper: AXI bundles)
    bundles: dict[Channel, int]
    n_bundles: int
    #: human-readable log from the pass pipeline + the fusion search
    diagnostics: list[str] = dataclasses.field(default_factory=list)

    def features(self, items: int = 1, spec=None) -> dict:
        """Drift-row features of this schedule under ``spec`` (default:
        an H100's); see :func:`repro_torch.core.vectorize.schedule_features`."""
        from repro_torch.core.vectorize import H100, schedule_features
        return schedule_features(self, items, spec if spec is not None
                                 else H100)

    def describe(self) -> str:
        """Render the schedule: kernels, FIFOs, tiles + provenance.

        Each fused kernel line reports its selected tile and *why* it
        was chosen (``via model`` — analytic sweep, ``via forced`` —
        explicit ``vector_factor=``, ``via measured`` / ``via cache`` /
        ``via config`` — the autotuner), followed by the pass-pipeline
        and ``[tune]`` diagnostics.
        """
        lines = [f"schedule for {self.graph.name!r}: "
                 f"{len(self.order)} stages -> {len(self.groups)} kernels"]
        for gi, g in enumerate(self.groups):
            kind = "custom" if g.is_trivial else "dataflow"
            names = ",".join(s.name for s in g.stages)
            lines.append(f"  kernel[{gi}] ({kind}): {names}")
            lines.append(f"    inputs={[c.name for c in g.inputs]} "
                         f"outputs={[c.name for c in g.outputs]} "
                         f"fifo={[c.name for c in g.internal]}")
            if g.tile is not None:
                lines.append(f"    tile={g.tile} "
                             f"vector_factor={g.vector_factor} "
                             f"via {g.tile_source}")
        lines.append("  bundles: " + ", ".join(
            f"{c.name}->mem{b}" for c, b in self.bundles.items()))
        if self.diagnostics:
            lines.append("  passes:")
            lines.extend(f"    {d}" for d in self.diagnostics)
        return "\n".join(lines)


def build_schedule(graph: DataflowGraph, n_bundles: int = 4, *,
                   canonicalize: bool = True, strict: bool = False,
                   passes: Sequence[Pass] | PassPipeline | None = None,
                   spec=None, vector_factor: int | None = None,
                   group_vector_factors: Sequence[int | None] | None = None,
                   max_tile: tuple[int, int] | None = None,
                   tile_source: str = "measured", trace=None) -> Schedule:
    """Canonicalize, validate and partition ``graph`` into fusion groups.

    ``strict=True`` skips canonicalization and enforces the paper's
    explicit canonical form (multi-reader channels raise).  ``passes``
    overrides the default pipeline; ``spec`` (a
    :class:`~repro_torch.core.vectorize.GPUSpec`) feeds the
    shared-memory feasibility check of the fusion search (default: an
    H100's).  ``max_tile`` caps the tile.  ``vector_factor`` forces one tile width
    (``32 * factor``) for every group; ``None`` (the default) sweeps
    tiles per group through the cost model
    (:func:`repro_torch.core.vectorize.select_tile`) and logs the
    choice in the schedule diagnostics.

    ``group_vector_factors`` is the autotuner's entry point (see
    :mod:`repro_torch.tune`): one factor per fusion group in schedule
    order (``None`` for trivial groups), each fixing that group's width
    while the model picks its height under ``max_tile``, labelled
    ``tile_source``.  A length mismatch, or a factor the group can no
    longer hold — a stale cached config after the partition or the plane
    changed — falls back to the analytic sweep with a diagnostic instead
    of failing.

    >>> from repro_torch.core.graph import DataflowGraph
    >>> g = DataflowGraph("doc")
    >>> x = g.input("img", (64, 256))
    >>> _ = g.output(g.point(x, lambda v: v + 1.0), "out")
    >>> sched = build_schedule(g)
    >>> len(sched.groups), sched.groups[0].tile_source
    (1, 'model')
    >>> build_schedule(g, vector_factor=2).groups[0].tile[1]
    64
    >>> tuned = build_schedule(g, group_vector_factors=[1])
    >>> tuned.groups[0].tile[1], tuned.groups[0].tile_source
    (32, 'measured')
    """
    diagnostics: list[str] = []
    if canonicalize and not strict:
        pipeline = passes if isinstance(passes, PassPipeline) else (
            PassPipeline(tuple(passes)) if passes is not None
            else default_pipeline())
        graph, diagnostics = pipeline.run(graph, tracer=trace)
    graph.validate()
    order = graph.toposort()
    with maybe_span(trace, "compile.partition", cat="compile",
                    graph=graph.name, stages=len(order)) as sp:
        groups, fusion_diags = _partition_groups(graph, order, spec,
                                                 vector_factor)
        sp.set(groups=len(groups))
    diagnostics.extend(fusion_diags)
    diagnostics.extend(_select_tiles(groups, spec, vector_factor,
                                     group_vf=group_vector_factors,
                                     max_tile=max_tile, source=tile_source,
                                     trace=trace))
    bundles = _assign_bundles(graph, n_bundles)
    return Schedule(graph, order, groups, bundles, n_bundles, diagnostics)


def _select_tiles(groups: list[FusionGroup], spec,
                  vector_factor: int | None,
                  group_vf: Sequence[int | None] | None = None,
                  max_tile: tuple[int, int] | None = None,
                  source: str = "measured", trace=None) -> list[str]:
    """Per-group tile selection (post-partition).

    Three modes, in precedence order: ``group_vf`` fixes each group's
    width (the autotuner applying a measured or cached config, labelled
    ``source``), ``vector_factor`` pins every group to one factor (the
    explicit knob), and otherwise each group is swept through the model.
    """
    from repro_torch.core.vectorize import select_tile
    diags: list[str] = []
    if group_vf is not None and len(group_vf) != len(groups):
        diags.append(f"[vectorize] tuned config has {len(group_vf)} "
                     f"group factors but the partition produced "
                     f"{len(groups)} groups; falling back to the "
                     f"analytic sweep")
        group_vf = None
    for gi, g in enumerate(groups):
        if g.is_trivial:
            continue
        names = ",".join(s.name for s in g.stages)
        g.tile_source = "forced" if vector_factor is not None else "model"
        tuned = group_vf[gi] if group_vf is not None else None
        if tuned is not None:
            try:
                tile, _ = select_tile(g, spec, None, max_tile, trace=trace,
                                      width_factor=tuned)
            except ValueError:
                # a persistent tuned config can outlive the partitioner
                # or the plane it was measured on; an explicit
                # vector_factor= stays a hard error, a stale cached
                # factor degrades to the sweep
                diags.append(f"[vectorize] {{{names}}}: tuned "
                             f"vector_factor={tuned} no longer feasible; "
                             f"falling back to the analytic sweep")
            else:
                g.tile_source = source
                diags.append(f"[vectorize] {{{names}}}: {source} "
                             f"vector_factor={tuned} tile={tile} "
                             f"smem={g.smem_bytes()}B")
                continue
        tile, sweep = select_tile(g, spec, vector_factor, max_tile,
                                  trace=trace)
        if sweep is not None:
            n_ok = sum(1 for r in sweep if r["feasible"])
            diags.append(f"[vectorize] {{{names}}}: swept {len(sweep)} "
                         f"tiles ({n_ok} feasible) -> tile={tile} "
                         f"smem={g.smem_bytes()}B")
        else:
            diags.append(f"[vectorize] {{{names}}}: {g.tile_source} "
                         f"vector_factor={g.vector_factor} tile={tile}")
    return diags


# ----------------------------------------------------------------------
# convex-subgraph DAG fusion
# ----------------------------------------------------------------------
def _is_fusible(st: Stage) -> bool:
    return (st.kind in FUSIBLE_KINDS
            and all(len(c.shape) == 2 for c in st.inputs + st.outputs))


def _partition_groups(graph: DataflowGraph, order: list[Stage],
                      spec=None, vector_factor: int | None = None
                      ) -> tuple[list[FusionGroup], list[str]]:
    """Grow maximal convex fusion groups over the stage DAG.

    Seeds one group per stage, then repeatedly merges the pair of
    edge-adjacent groups with the largest modeled latency win
    (``analytic_latency``: a merge removes one device-memory write+read
    round-trip and lets both halves drain at the slower rate instead
    of sequentially).  A merge is legal iff both groups are fusible on
    the same plane shape, the union is *convex* in the DAG — no path
    between two member stages passes through an outside stage — and
    :func:`~repro_torch.core.vectorize.choose_tile` can still fit the
    union's halo windows in shared memory.
    """
    n = len(order)
    pos = {st: i for i, st in enumerate(order)}

    succ: list[set[int]] = [set() for _ in range(n)]
    for i, st in enumerate(order):
        for ch in st.outputs:
            for c in ch.consumers:
                succ[i].add(pos[c])

    # reach[i]: bitmask of stages strictly reachable from i
    reach = [0] * n
    for i in reversed(range(n)):
        m = 0
        for j in succ[i]:
            m |= (1 << j) | reach[j]
        reach[i] = m

    owner = list(range(n))                      # stage idx -> group id
    members: dict[int, int] = {i: 1 << i for i in range(n)}
    fusible = [_is_fusible(st) for st in order]
    shape: dict[int, tuple[int, ...]] = {
        i: order[i].outputs[0].shape if order[i].outputs else ()
        for i in range(n)}

    def is_convex(union: int) -> bool:
        above = 0
        for i in _bits(union):
            above |= reach[i]
        for x in _bits(above & ~union):
            if reach[x] & union:
                return False
        return True

    def make_group(mask: int) -> FusionGroup:
        g = FusionGroup([order[i] for i in _bits(mask)], [], [], [], {})
        _classify_channels(g, graph)
        g.halo = _halo_analysis(g)
        return g

    # masks are immutable ints: memoize the per-candidate work so each
    # merge round only evaluates unions it has not seen before
    _fits_cache: dict[int, bool] = {}
    _lat_cache: dict[int, float] = {}

    def fits_smem(mask: int) -> bool:
        # feasibility floor: a forced factor must fit every merged
        # group; in auto-sweep mode the narrowest datapath (vf=1) is
        # the existence check — select_tile widens afterwards.
        if mask not in _fits_cache:
            from repro_torch.core.vectorize import choose_tile
            g = make_group(mask)
            try:
                choose_tile(g, spec, vector_factor or 1)
                _fits_cache[mask] = True
            except ValueError:
                _fits_cache[mask] = False
        return _fits_cache[mask]

    def latency(mask: int) -> float:
        if mask not in _lat_cache:
            tasks = ([TaskTiming("read", ii=1.0, fill=32.0)]
                     + [TaskTiming(order[i].name, ii=order[i].ii,
                                   fill=order[i].fill) for i in _bits(mask)]
                     + [TaskTiming("write", ii=1.0, fill=32.0)])
            _lat_cache[mask] = analytic_latency(tasks,
                                                _COST_ITEMS)["dataflow"]
        return _lat_cache[mask]

    n_merges = 0
    while True:
        pairs: set[tuple[int, int]] = set()
        for i in range(n):
            for j in succ[i]:
                ga, gb = owner[i], owner[j]
                if ga != gb:
                    pairs.add((min(ga, gb), max(ga, gb)))
        best: tuple[float, int, int, int] | None = None
        for ga, gb in sorted(pairs):
            if not (fusible[ga] and fusible[gb]):
                continue
            if shape[ga] != shape[gb]:
                continue
            union = members[ga] | members[gb]
            if not is_convex(union):
                continue
            if not fits_smem(union):
                continue
            gain = latency(members[ga]) + latency(members[gb]) \
                - latency(union)
            if best is None or gain > best[0]:
                best = (gain, ga, gb, union)
        if best is None:
            break
        _, ga, gb, union = best
        members[ga] = union
        del members[gb]
        for i in _bits(union):
            owner[i] = ga
        n_merges += 1

    groups = [make_group(members[g]) for g in _order_groups(members, succ)]
    diags = [f"[convex-fusion] {n} stages -> {len(groups)} groups "
             f"({n_merges} merges)"]
    for g in groups:
        if len(g.stages) > 1:
            diags.append(
                f"[convex-fusion] fused {{{','.join(s.name for s in g.stages)}}}"
                f" into one streaming kernel")
    return groups, diags


def _order_groups(members: dict[int, int], succ: list[set[int]]
                  ) -> list[int]:
    """Topological order of the (convex => acyclic) group DAG.

    Deterministic: ready groups are taken lowest-member-index first,
    so the result is stable across runs.
    """
    owner = {i: g for g, mask in members.items() for i in _bits(mask)}
    gsucc: dict[int, set[int]] = {g: set() for g in members}
    indeg: dict[int, int] = {g: 0 for g in members}
    for i, js in enumerate(succ):
        for j in js:
            a, b = owner[i], owner[j]
            if a != b and b not in gsucc[a]:
                gsucc[a].add(b)
                indeg[b] += 1
    ready = sorted(g for g in members if indeg[g] == 0)
    out: list[int] = []
    while ready:
        g = ready.pop(0)
        out.append(g)
        for nb in sorted(gsucc[g]):
            indeg[nb] -= 1
            if indeg[nb] == 0:
                ready.append(nb)
        ready.sort()
    return out


def _bits(mask: int):
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


def _classify_channels(g: FusionGroup, graph: DataflowGraph) -> None:
    inside = set(g.stages)
    seen: set[Channel] = set()
    for st in g.stages:
        for ch in st.inputs:
            if ch in seen:
                continue
            seen.add(ch)
            if ch.producer not in inside:
                g.inputs.append(ch)
        for ch in st.outputs:
            if ch in seen:
                continue
            seen.add(ch)
            consumers_inside = ch.consumers and all(
                c in inside for c in ch.consumers)
            if ch.is_graph_output or not consumers_inside:
                g.outputs.append(ch)
            else:
                g.internal.append(ch)


# ----------------------------------------------------------------------
# halo (line-buffer) analysis
# ----------------------------------------------------------------------
def _halo_analysis(g: FusionGroup) -> dict[Channel, tuple[int, int]]:
    """Cumulative halo per channel, by backward DP over the group.

    ``halo(ch) = max over consumers st of halo(st.output) + st.halo``;
    group outputs carry halo (0, 0).  This is exactly the line-buffer
    depth a chained FPGA stencil pipeline needs, expressed in tiles.
    """
    halo: dict[Channel, tuple[int, int]] = {}
    inside = set(g.stages)
    for ch in g.outputs:
        halo[ch] = (0, 0)
    for st in reversed(g.stages):  # reverse topo order within the group
        out_halos = [halo.get(ch, (0, 0)) for ch in st.outputs]
        oh = (max(h[0] for h in out_halos), max(h[1] for h in out_halos))
        ih = (oh[0] + st.halo[0], oh[1] + st.halo[1])
        for ch in st.inputs:
            prev = halo.get(ch, (0, 0))
            cand = ih if ch.producer in inside or ch in g.inputs else (0, 0)
            halo[ch] = (max(prev[0], cand[0]), max(prev[1], cand[1]))
    return halo


# ----------------------------------------------------------------------
# memory bundles (paper Fig. 4)
# ----------------------------------------------------------------------
def _assign_bundles(graph: DataflowGraph, n_bundles: int) -> dict[Channel, int]:
    """Assign distinct memory "bundles" to parallel I/O paths.

    Heuristic matching the paper: I/O channels on *different* branches
    of the DAG should land on different bundles so their transfers do
    not serialize on one interface.  We walk graph I/O in order and
    round-robin, but force siblings (channels touching the same stage)
    apart when possible.
    """
    io = graph.graph_inputs + graph.graph_outputs
    bundles: dict[Channel, int] = {}
    nxt = 0
    for ch in io:
        taken = set()
        peers = ch.consumers + ([ch.producer] if ch.producer else [])
        for st in peers:
            for other in st.inputs + st.outputs:
                if other in bundles:
                    taken.add(bundles[other])
        b = nxt % n_bundles
        for _ in range(n_bundles):
            if b not in taken:
                break
            b = (b + 1) % n_bundles
        bundles[ch] = b
        ch.bundle = b
        nxt += 1
    return bundles
