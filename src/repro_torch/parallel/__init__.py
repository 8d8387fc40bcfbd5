"""Replication across devices (port of :mod:`repro.parallel`).

``sharding.py`` holds the replica mesh, ``collectives.py`` the row-halo
exchange and ``replicate.py`` the row-partitioned replication of a
compiled dataflow app (:func:`replicate_app`).  The reference's
logical-axis sharding rules, ring collectives and pipeline parallelism
are not ported yet (``ROADMAP.md`` A9); ``_compat.py`` is a JAX shim
with no counterpart.
"""
from repro_torch.parallel.collectives import halo_exchange_rows
from repro_torch.parallel.replicate import (UNROUTED_COMPILE_KWARGS,
                                            ReplicatedApp, graph_input_halo,
                                            replicate_app,
                                            replication_kwarg_routing)
from repro_torch.parallel.sharding import ReplicaMesh, replica_mesh

__all__ = ["ReplicaMesh", "replica_mesh", "halo_exchange_rows",
           "ReplicatedApp", "replicate_app", "graph_input_halo",
           "replication_kwarg_routing", "UNROUTED_COMPILE_KWARGS"]
