"""Process groups, meshes and training steps of the port (counterpart of
``mxnet_tpu/parallel``): the data-parallel regime.  Tensor, sequence,
pipeline and expert parallelism come with later slices."""
from .mesh import (Mesh, Sharding, TrainStep, batch_sharded,
                   init_process_group, make_mesh, replicated)

__all__ = ["Mesh", "Sharding", "TrainStep", "batch_sharded",
           "init_process_group", "make_mesh", "replicated"]
