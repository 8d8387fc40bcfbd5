"""Model parallelism and replication across devices (port of
:mod:`repro.parallel`).

``sharding.py`` holds the meshes (:class:`Mesh`, the 1-D
:class:`ReplicaMesh`), the logical-axis rules and the port's own
``PartitionSpec`` / ``NamedSharding`` / ``ShardedTensor``;
``collectives.py`` the row-halo exchange, the ring matmuls and the
gradient reduce-scatter; ``pipeline.py`` GPipe's ``pipeline_apply``;
``replicate.py`` the row-partitioned replication of a compiled dataflow
app (:func:`replicate_app`).  All are single-controller: one process
drives every device of a mesh.  ``_compat.py`` is a JAX shim with no
counterpart.
"""
from repro_torch.parallel.collectives import (halo_exchange_rows,
                                              psum_scatter_grads,
                                              ring_allgather_matmul,
                                              ring_matmul_reducescatter)
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.replicate import (UNROUTED_COMPILE_KWARGS,
                                            ReplicatedApp, graph_input_halo,
                                            replicate_app,
                                            replication_kwarg_routing)
from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES, Mesh,
                                           NamedSharding, P, PartitionSpec,
                                           ReplicaMesh, ShardedTensor,
                                           ShardingRules, make_mesh,
                                           make_param_shardings,
                                           mesh_axis_size, replica_mesh,
                                           shard_tree, spec_for_axes)

__all__ = ["ReplicaMesh", "replica_mesh", "Mesh", "make_mesh",
           "PartitionSpec", "P", "NamedSharding", "ShardedTensor",
           "ShardingRules", "TRAIN_RULES", "SERVE_RULES", "mesh_axis_size",
           "spec_for_axes", "make_param_shardings", "shard_tree",
           "halo_exchange_rows", "ring_allgather_matmul",
           "ring_matmul_reducescatter", "psum_scatter_grads",
           "pipeline_apply", "ReplicatedApp", "replicate_app",
           "graph_input_halo", "replication_kwarg_routing",
           "UNROUTED_COMPILE_KWARGS"]
