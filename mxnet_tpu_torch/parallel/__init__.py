"""Process groups, meshes, training steps and the parallel regimes of the
port (counterpart of ``mxnet_tpu/parallel``): data and tensor parallelism
through :class:`TrainStep`, the canonical parameter placements of
:mod:`.speclayout` (data, fsdp and tp axes) that the sharded
``CompiledStep`` trains over, the explicit sharded compute of
:mod:`.tensor`, and sequence (ring, Ulysses), pipeline and expert
parallelism through :mod:`.ring`, :mod:`.pipeline` and :mod:`.moe` over a
mesh's axes."""
from .mesh import (Mesh, Sharding, TrainStep, batch_sharded,
                   end_process_group, init_process_group, make_mesh,
                   replicated, shard_params_tp)
from .speclayout import (SpecLayout, layout_from_env, mesh_for_world,
                         mesh_from_env, shard_params, tp_alternation_specs)
from .ring import (context_parallel_attention, ring_attention,
                   ulysses_attention)
from .pipeline import pipeline_apply, pipeline_parallel
from .moe import moe_apply, moe_parallel, top1_dispatch

__all__ = ["make_mesh", "replicated", "batch_sharded", "shard_params_tp",
           "SpecLayout", "shard_params", "tp_alternation_specs",
           "layout_from_env", "mesh_from_env", "mesh_for_world",
           "TrainStep", "init_process_group", "ring_attention",
           "ulysses_attention", "context_parallel_attention",
           "pipeline_apply", "pipeline_parallel", "moe_apply",
           "moe_parallel", "top1_dispatch", "Mesh", "Sharding",
           "end_process_group"]
