"""The bytes the port's collectives move between mesh positions.

The reference reads its collective bytes off the optimized HLO
(``repro.analysis.hlo.collective_bytes``).  The port produces no HLO,
so its own collectives report what they move instead, under the
reference's five kinds:

- ``all-gather``: a :class:`~repro_torch.parallel.sharding.ShardedTensor`
  gathered onto a data shard's position (the parameters a sharded step
  gathers, a data shard's cache slots): every piece that position does
  not hold;
- ``reduce-scatter``: the gradients' sum over the data shards and its
  split per spec (``collectives.reduce_scatter``, ``psum_scatter_grads``):
  each data shard's part moved to the first one, then each position's
  piece of the float32 sum;
- ``collective-permute``: ring hops (``collectives.ppermute``) and a data
  shard's cache slots written back to the positions that hold them;
- ``all-reduce`` and ``all-to-all``: nothing in the port reports them.

A move counts whether or not the two positions share a device (a mesh
may stand on one card, or on ``meta`` in a dry run).  Counting is on
only inside :func:`count_traffic`; elsewhere :func:`active` is one
context-variable read, and the callers compute no byte count.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

__all__ = ["KINDS", "count_traffic", "active", "report"]

#: the reference's collective kinds (``repro.analysis.hlo.COLLECTIVES``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_COUNTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "collective_traffic", default=None)


@contextlib.contextmanager
def count_traffic() -> Iterator[dict]:
    """Counts the collectives run inside the block.  Yields a dict of
    bytes a kind (:data:`KINDS`), ``"ops"`` (reports) and, once the block
    ends, ``"total"``, the keys of ``collective_bytes``."""
    counts: dict = {k: 0.0 for k in KINDS}
    counts["ops"] = 0
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)
        counts["total"] = float(sum(counts[k] for k in KINDS))


def active() -> bool:
    """Whether a :func:`count_traffic` block is counting."""
    return _COUNTS.get() is not None


def report(kind: str, nbytes: float) -> None:
    """Adds one collective of ``kind`` moving ``nbytes`` bytes."""
    counts = _COUNTS.get()
    if counts is None:
        return
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    counts[kind] += float(nbytes)
    counts["ops"] += 1
