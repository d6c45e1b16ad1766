"""Gluon layers of the port."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, ELU,
                           Embedding, GELU, GroupNorm, HybridSequential,
                           InstanceNorm, LayerNorm, LeakyReLU, PReLU, SELU,
                           Sequential, SyncBatchNorm, set_dropout_generator)
from .conv_layers import *      # noqa: F401,F403
from . import conv_layers as _conv_layers

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "ELU", "Embedding",
           "GELU", "GroupNorm", "HybridSequential", "InstanceNorm",
           "LayerNorm", "LeakyReLU", "PReLU", "SELU", "Sequential",
           "SyncBatchNorm", "set_dropout_generator"] + _conv_layers.__all__
