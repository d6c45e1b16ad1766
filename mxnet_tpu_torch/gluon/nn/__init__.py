"""Gluon layers of the port."""
from .basic_layers import (Activation, BatchNorm, Concatenate, Dense,
                           Dropout, ELU, Embedding, Flatten, GELU, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           LeakyReLU, PReLU, SELU, Sequential, SiLU, Swish,
                           SyncBatchNorm, set_dropout_generator)
from .conv_layers import *      # noqa: F401,F403
from . import conv_layers as _conv_layers

__all__ = ["Activation", "BatchNorm", "Concatenate", "Dense", "Dropout",
           "ELU", "Embedding", "Flatten", "GELU", "GroupNorm",
           "HybridConcatenate", "HybridLambda", "HybridSequential",
           "Identity", "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU",
           "PReLU", "SELU", "Sequential", "SiLU", "Swish", "SyncBatchNorm",
           "set_dropout_generator"] + _conv_layers.__all__
