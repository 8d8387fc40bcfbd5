"""FLOWER dataflow compiler on PyTorch (port of :mod:`repro.core`).

Layers:
  graph.py     — dataflow-graph extraction & validation       (C1)
  transform.py — canonicalization pass pipeline               (C1b)
  schedule.py  — toposort, convex DAG fusion, halo, bundles    (C2, C3c)
  vectorize.py — tile selection for shared memory (H100)       (C3b)
  fusion.py    — lowering: generated CUDA kernel / torch ops   (C2, C3a)
  host.py      — host-code generation (launcher, buffers)      (C4)
  compiler.py  — the entry point: canonicalize→validate→partition→lower
  simulate.py  — FIFO pipeline latency model (paper Fig. 1)
"""
from repro_torch.core.graph import (Channel, ChannelContractError, CycleError,
                                    DataflowGraph, GraphError, Stage)
from repro_torch.core.transform import (AutoSplitInsertion,
                                        DeadChannelElimination, Pass,
                                        PassPipeline, PointFusion,
                                        default_pipeline)
from repro_torch.core.schedule import FusionGroup, Schedule, build_schedule
from repro_torch.core.vectorize import (GPUSpec, H100, choose_tile,
                                        select_tile)
from repro_torch.core.fusion import lower_graph, lower_group
from repro_torch.core.host import CompiledApp, LaunchHandle, build_host_app
from repro_torch.core.compiler import compile_graph
from repro_torch.core.simulate import (TaskTiming, analytic_latency,
                                       simulate_pipeline)

__all__ = [
    "Channel", "ChannelContractError", "CycleError", "DataflowGraph",
    "GraphError", "Stage", "Pass", "PassPipeline", "AutoSplitInsertion",
    "DeadChannelElimination", "PointFusion", "default_pipeline",
    "FusionGroup", "Schedule", "build_schedule", "GPUSpec", "H100",
    "choose_tile", "select_tile", "lower_graph", "lower_group",
    "CompiledApp", "LaunchHandle", "build_host_app", "compile_graph",
    "TaskTiming", "analytic_latency", "simulate_pipeline",
]
