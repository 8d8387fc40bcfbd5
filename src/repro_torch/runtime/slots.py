"""Fixed-slot scheduling machinery (a copy of ``repro.runtime.slots``).

A serving scheduler here is a FIFO admission queue feeding a fixed pool
of *slots*, with items retired out of slots as they complete.
:class:`~repro_torch.runtime.batcher.ContinuousBatcher` uses the pool
for decode slots (a slot = one sequence's rows of the KV cache); in the
reference the dataflow ``StreamEngine`` shares it for in-flight
launches, and will here when the engine is ported.

:class:`SlotPool` is that shared core: bounded occupancy, FIFO
admission, admission-order retirement bookkeeping.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

__all__ = ["SlotPool"]


class SlotPool:
    """A fixed pool of serving slots fed from a FIFO admission queue."""

    def __init__(self, n_slots: int) -> None:
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.slots: list[Any | None] = [None] * n_slots
        self.queue: deque[Any] = deque()
        self.finished: list[Any] = []
        self._order: deque[int] = deque()   # admission order of busy slots

    # -- admission -----------------------------------------------------
    def submit(self, item: Any) -> None:
        """Enqueue an item for admission into the next free slot."""
        self.queue.append(item)

    def admit(self) -> list[tuple[int, Any]]:
        """Move queued items into free slots (FIFO); return admissions."""
        admitted: list[tuple[int, Any]] = []
        for slot in self.free_slots():
            if not self.queue:
                break
            item = self.queue.popleft()
            self.slots[slot] = item
            self._order.append(slot)
            admitted.append((slot, item))
        return admitted

    # -- occupancy -----------------------------------------------------
    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def busy(self) -> bool:
        """True while anything is queued or occupying a slot."""
        return bool(self.queue) or self.active > 0

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def oldest(self) -> int | None:
        """Slot id of the earliest-admitted busy slot (FIFO retire order)."""
        return self._order[0] if self._order else None

    def ready(self, is_ready: Callable[[Any], bool]) -> list[int]:
        """Busy slots (admission order) whose item can retire *now*.

        The continuous-batching schedulers use this to refill freed
        slots as items complete instead of draining the whole pool at
        a barrier: the engine polls in-flight launches with a
        non-blocking readiness probe, the LM batcher retires finished
        sequences, and in both cases ``admit()`` immediately backfills
        the freed slots from the queue.
        """
        return [s for s in self._order if is_ready(self.slots[s])]

    # -- retirement ----------------------------------------------------
    def retire(self, slot: int) -> Any:
        """Free ``slot``; its item moves to ``finished`` and is returned."""
        item = self.slots[slot]
        if item is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        self._order.remove(slot)
        self.finished.append(item)
        return item
