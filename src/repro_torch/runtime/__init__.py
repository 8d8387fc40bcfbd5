"""Serving runtimes of the port (``repro.runtime``).

``engine.py`` is the dataflow serving engine (:class:`StreamEngine`);
``cache.py``/``batching.py``/``telemetry.py``/``slots.py`` are its
parts.  The LM-serving scheduler (``batcher.py``) and its step builders
(``steps.py``) live beside it and are imported directly — they pull in
the model stack, which this package namespace deliberately does not.
"""
from repro_torch.runtime.batching import MicroBatcher
from repro_torch.runtime.cache import CacheStats, CompileCache
from repro_torch.runtime.engine import (CancelledError, QueueFullError,
                                        StreamEngine, StreamRequest)
from repro_torch.runtime.slots import SlotPool
from repro_torch.runtime.telemetry import PHASES, Telemetry, modeled_latency

__all__ = [
    "MicroBatcher", "CacheStats", "CompileCache", "CancelledError",
    "QueueFullError", "StreamEngine", "StreamRequest", "SlotPool",
    "Telemetry", "PHASES", "modeled_latency",
]
