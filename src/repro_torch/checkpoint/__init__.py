"""Atomic, asynchronous checkpoints in the reference's on-disk format
(the port of ``repro.checkpoint``)."""
