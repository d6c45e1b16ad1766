"""Training steps of the port (counterpart of ``mxnet_tpu/parallel``).

This slice has the one-device :class:`TrainStep`; meshes, sharding and the
parallel regimes come with the distributed slice."""
from .mesh import TrainStep

__all__ = ["TrainStep"]
