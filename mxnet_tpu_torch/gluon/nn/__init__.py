"""Gluon layers of the port (reference: python/mxnet/gluon/nn/), with the
base blocks re-exported as the reference does (``class
Net(gluon.nn.HybridBlock)``)."""
from ..block import Block, HybridBlock
from .basic_layers import (Activation, BatchNorm, Concatenate, Dense,
                           Dropout, ELU, Embedding, Flatten, GELU, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           LeakyReLU, PReLU, SELU, Sequential, SiLU, Swish,
                           SyncBatchNorm, set_dropout_generator)
from .conv_layers import *      # noqa: F401,F403
from . import conv_layers as _conv_layers

__all__ = ["Block", "HybridBlock", "Activation", "BatchNorm", "Concatenate", "Dense", "Dropout",
           "ELU", "Embedding", "Flatten", "GELU", "GroupNorm",
           "HybridConcatenate", "HybridLambda", "HybridSequential",
           "Identity", "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU",
           "PReLU", "SELU", "Sequential", "SiLU", "Swish", "SyncBatchNorm",
           "set_dropout_generator"] + _conv_layers.__all__
