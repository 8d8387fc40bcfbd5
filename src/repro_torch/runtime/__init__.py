"""Serving runtime of the port: the LM continuous batcher, its slot pool
and step builders (``repro.runtime``)."""
