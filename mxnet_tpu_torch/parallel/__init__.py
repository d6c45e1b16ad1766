"""Process groups, meshes, training steps and the parallel regimes of the
port (counterpart of ``mxnet_tpu/parallel``): data parallelism through
:class:`TrainStep`, sequence (ring, Ulysses), pipeline and expert
parallelism through :mod:`.ring`, :mod:`.pipeline` and :mod:`.moe` over a
mesh's axes.  Tensor parallelism (``speclayout``, ``shard_params_tp``)
comes with its own slice."""
from .mesh import (Mesh, Sharding, TrainStep, batch_sharded,
                   init_process_group, make_mesh, replicated)
from .ring import (context_parallel_attention, ring_attention,
                   ulysses_attention)
from .pipeline import pipeline_apply, pipeline_parallel
from .moe import moe_apply, moe_parallel, top1_dispatch

__all__ = ["Mesh", "Sharding", "TrainStep", "batch_sharded",
           "init_process_group", "make_mesh", "replicated",
           "ring_attention", "ulysses_attention",
           "context_parallel_attention", "pipeline_apply",
           "pipeline_parallel", "moe_apply", "moe_parallel",
           "top1_dispatch"]
